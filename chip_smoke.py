"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into the
git-ignored ``build/``), then runs these phases, one or more lines each:

1. environment: the card's name and power limit, torch / CUDA versions and
   the kernel build time;
2. every kernel against its plain PyTorch version on the card, with its
   time, the plain version's, a PyTorch library call's (a yardstick only)
   and the least time the card could take (``bound_ms``): the solve's
   ``bid_top2`` (the digests of its bits at the checked shapes; timed as
   the main path launches it, the span's pair in one launch, and as one
   call, also with c staged by the threads; one call and the pair against
   their plain versions at every checked shape, exact on integers; the
   pair's slot 0 bitwise one call and both slots within tolerance of the
   plain pair on the main data and on a LAP with dummy rows),
   ``gather_rows`` and ``auction_phase`` (every phase of 65
   LAPs of the main data and a set of edge cases against the Python round
   loop over ``bid_top2``, bitwise, with the same rounds, bids and
   single-bidder rounds; then the SM clock cycles of every round of the
   first 16 LAPs by bidder count, from the kernel's timed instantiation,
   under its own crossover and with every round sent to each of its two
   paths), ``auction_phase_dense`` (one launch a LAP, all its phases: the
   65 launches of the first 65 LAPs of the main data on the default flat
   route, a G = 3 warm stack with skips and seed, ``fixed_rounds``, a
   biting ``max_rounds``, integer costs, n = 1, 100, 250, 512 and 8192
   (every cost row staged, some, none), all bitwise against the
   every-round Python loop over ``top2``, phase after phase; then every
   masked LAP of phase 7's call (b), whose quota mask puts -1e9 in the
   cost, and a warm G = 3 stack of them, likewise; one masked LAP timed
   beside an unmasked one, and the cycles of their rounds by bidder count
   and by step through the dense kernel's timed instantiation, under its
   crossover, forced to each path and by where the cost row lives; the
   latency floor of the timed LAP); at phase 8's shapes, the dense kernel
   on the G = 64, n = 64 stack of call (a)'s first level-2 LAP and on call
   (c)'s first level-2 batch (G = 256, n = 512), the factored kernel on
   call (b)'s first G = 64 LAP, bitwise against the loop, the span's pair
   on (b)'s first LAP at G = 1 and at G = 64 against the plain pair, and
   the dense rounds by bidder count on 16 LAPs at n = 64 and at n = 512;
   at phase 10's sequencer shape (k = 495, the stream route) the factored
   kernel bitwise the loop on every phase of the sequencer's first LAP and
   the span's pair there against its plain version; each phase kernel's
   per-group ``rounds_g`` (the telemetry's rounds) equal to its plain
   twin's exact count there and on a G = 3 warm dense stack of that LAP;
   at phase 11's mesh shapes, the same factored checks on the first LAP
   of shard 0 of the 2-shard mesh call (k_local = 128) and of the mesh
   sequencer (k_local = 264), and the dense kernel with its ``rounds_g``
   on the first LAP of the mesh router's request (n = 128); then the
   kernel entry point's
   ``cdist``, ``cdist_gather``, ``bid_top2_gather`` and ``ssm_scan`` at the
   shapes phase 5 gives them (``bid_top2_gather`` also at m = 65 536, each
   shape timed in turns with its previous design and beside the library
   call, with its stages' SM cycles from its timed instantiation;
   ``ssm_scan`` also with its expf count and
   their special-function floor at the data sheet's clock and at the SM
   clock read while calls of it run);
3. the main path: ``anticluster(x, k=256, chunk_size="auto")`` on the
   paper's *diabetes* shape (n = 253 680, d = 22), which takes the
   ``"stream"`` route with the ``"auction_fused"`` solver.  First the
   process's first call of that path, then a second, identical one (the
   main call) with the kernels' launch counters zeroed just before it and
   read just after, then a profile of the first few batches of one chunk,
   then a window of 20 LAPs in the middle of a third call profiled (no
   copy between host and card and no wait on the card in a LAP);
4. the same path at n = PLAIN_N (2048) against the plain kernels, and the
   default spec's flat route at that n against the forced plain path (the
   Python loop over ``top2``): labels bitwise equal, both times; likewise
   phase 7's calls (a), (b) and (d) at that n, and the categorical stream
   core with ``chunk_size >= n`` against the flat core; the hierarchical
   route ``plan=(8, 16)``, dense and with ``chunk_size=1024``, against the
   forced plain path (labels bitwise), and ``batched=False`` against the
   stacked levels (labels equal, or the first LAP that differs and why);
5. the kernel entry point ``repro_torch.kernels`` at full size, driven
   once with the launch counters zeroed just before and read just after:
   ``cdist`` of the diabetes rows against k = 256 centroids,
   ``cdist(idx=)`` and ``bid_top2(idx=)`` on one streaming chunk's 8192
   indices, and ``ssm_scan`` at one falcon-mamba-7b layer's width;
6. the default route: ``anticluster(x, k=256)`` with the default spec on
   phase 3's rows (the ``"flat"`` route, the dense ``"auction"`` solver,
   every LAP one ``auction_phase_dense`` launch), a first call and the
   main call with the counters zeroed just before it and read just after,
   logged beside phase 3's stream route; a window of 20 LAPs in the middle
   of a third call profiled (launches, copies and waits a LAP, none
   between host and card or on the card; the device's idle share) and a fourth call profiled whole (the dense
   kernel's device time over the call); then a stacked (4, 16384, 22)
   input through the same solver;
7. the constrained routes on phase 3's rows at k = 256, each a first call
   (its LAPs counted, and those holding the quota mask) and a main call
   with the counters zeroed just before it and read just after: (a)
   ``categories`` (the diabetes_012 class counts), (b) ``fairness`` over
   class, sex and age, (c) ``categories`` with ``chunk_size="auto"``
   (``"stream"``, the solver kept ``"auction"``), (d) the rows padded to
   262 144 under a ``valid_mask``, (e) a stacked (4, 16384, 22) input with
   categories; one dense launch a LAP, exact balance, constraint (5) for
   one attribute, (b)'s largest quota excess logged; a third call each
   with a window of LAPs profiled (launches and copies a LAP, none
   between host and card, and no wait on the card);
8. the hierarchical route (paper Section 4.4) on the Table-10 rows of
   ``benchmarks/table10_scale.py`` (n = 2^20, d = 32, low rank), each a
   first call (its LAPs counted by level) and a main call with the
   counters zeroed just before it and read just after ((a), (b) and (d)
   one call each, which counts): (a) k = 4096
   (plan (64, 64), dense), (b) the same with ``chunk_size="auto"`` (level 1
   streamed, ``"auction_fused"``), (d) (a) with ``categories=`` (one
   call), (c) k = 131072 (plan (256, 512); one call if the phase has
   passed HIER_PHASE_BUDGET_S); the LAPs of each level and the kernels'
   launches a LAP, exact balance, constraint (5) for (d), the objective
   above random, a finite gap >= 0, the labels' sha256; (a) and (b) with
   20 LAPs of each level profiled inside the call (device launches a
   LAP at G = 1 and G = 64: no copy between host and card, no wait); then
   (e)
   ``kplus_moments=2`` on phase 3's rows at k = 256, its moment-2 spread
   below the same call's without k-plus;
9. sessions at full size on phase 3's rows at k = 256
   (``AnticlusterEngine``, ``repro_torch.incremental``): (a) the default
   spec's engine, ``partition`` (labels bitwise phase 6's) and three warm
   ``repartition`` calls, each with its rounds, launches and the phases
   its LAPs sat out, exact balance and the objective within 1 % of the
   cold call's, then a window of 20 warm LAPs profiled (no host read or
   wait in a LAP); (b) the same with ``chunk_size="auto"`` (the stream
   route, labels bitwise phase 3's); (c) ``update`` of (a)'s session with
   1 % of the rows out and as many in: one ``auction_phase_dense`` launch
   on the (B, 256, 256) delta stack, exact balance, the kept rows' labels
   kept, the objective within 1e-3 of a warm full repartition of the
   post-delta rows, equal labels on a second run, an over-threshold
   delta's fallback bitwise that repartition; (d) ``dispatch_repartition``
   on (a)'s session, ``wait()`` bitwise ``repartition``, with the host
   time it frees; (e) a warm repartition and an update at n = 4 096 on
   the flat route and ``plan=(8, 16)``, labels bitwise the forced plain
   path's; (f) the ``greedy`` and ``scipy`` solvers on the main data's
   first LAP beside the auction;
10. the consumers at full size on phase 3's rows (``repro_torch.data``,
   ``repro_torch.serve``, ``repro_torch.obs``): (a) ``ABABatchSequencer(x,
   batch_size=512)`` (k = 495, the stream route, ``"auction_fused"``), its
   partition, two warm epochs on drifted features and ``grow`` by 1 %, each
   with its rounds equal to those its telemetry sums, exact batch sizes
   (floor/ceil after ``grow``), the same schedule from a second
   sequencer, the batches' diversity spread below random batches'; (b)
   ``aba_folds(x, 10, categories=class)`` (the stream route, one dense
   launch a LAP; constraint (5) exact, ``fold_splits`` covering every row
   once) and ``fold_partition(x, 10)`` with an update of 1 %; (c) a burst
   of 32 requests of 12 288-16 384 rows through ``AnticlusterRouter(k=256,
   plan=None)``, stacked (``max_group=8``) and one by one, every ticket
   balanced and within 1e-3 of its one-shot objective (the bitwise ones
   counted), the metrics and throughput, then a live partition with two
   updates; (d) tracing on around an engine's flat and stream call with
   ``telemetry=True`` (the span's ``rounds_total`` equal to the kernels'
   rounds, the labels those without telemetry, no host read or wait in a
   LAP), device launches a LAP equal with tracing on and off, and
   ``obs.memory_profile`` of the flat and the stream call;
11. the mesh route, the pipeline and the baselines on phase 3's rows: (a)
   ``anticluster(x, k=256, mesh=...)`` on a 1-shard mesh (labels bitwise
   phase 6's, and with ``chunk_size="auto"`` phase 3's) and on a 2-shard
   mesh of the one card (126 840 rows and k_local = 128 a shard, each
   shard streamed: labels bitwise the shards solved one by one plus the
   offset, exact balance, each shard's labels in its own range, the
   launches the shards' own), a mesh engine's ``partition`` (bitwise the
   one-shot) and two warm ``repartition`` calls carrying a
   ``ShardedABAState``, the sequencer (batch_size 480, k = 528), the folds
   (16 384 rows) and a router lane with that mesh; (b) ``ABAPipeline(x,
   batch_size=512)`` for three epochs on drifted features, each consumed
   by a fixed device workload, labels and batches bitwise a sequencer's
   epoch by epoch, with the time its dispatched solves had, its stalls
   and the overlap; (c) at n = 16 384, k = 256, ABA's objective and time
   on the card beside ``fast_anticlustering`` and ``random_partition`` on
   the host;
12. the model stack: falcon-mamba-7b at full width and depth (64 layers,
   7 272 665 088 parameters, random weights drawn on the card from a
   seed) served by ``Generator``: (a) ``init_params`` with its count,
   bytes and peak memory; (b) ``generate`` on 2 seeded prompts of 2 048
   tokens with 64 greedy steps: the prefill's time and tokens/s, the
   decode steps' tokens/s, ``ssm_scan`` 64 launches in the prefill and
   none in decode, a profiled prefill and decode step by kernel with
   their idle shares; (c) the same prefill under ``ops.forced_path("ref")``
   (no launch): each layer's final h and the last logits within twice
   bfloat16's own spread (the distance of the plain path from the prefill
   in float32 compute), 16 greedy tokens equal up to the first step whose
   top-2 margin is under that tolerance; in float32 compute, at S = 256,
   the two paths within 1e-4 of the largest h and logit, and 16 greedy
   tokens likewise; (d) 16 greedy steps again equal, 16 sampled steps
   (``temperature=1.0``) in range and unlike greedy; (e) at S = 256 the
   first decode step's logits
   against ``forward`` on the extended sequence, within twice bfloat16's
   spread;
13. the model stack: the dense attention family at full width and depth,
   random weights drawn on the card from a seed, served by ``Generator``
   (no kernel of the repo runs: the reference's attention is plain
   ``jnp``; every row of the kernels line counts 0 launches here).
   gemma2-2b (26 layers, 2 614 341 888 parameters; GQA 8/4, head_dim
   256, softcaps, local layers with a 4 096-token window, post-block
   norms, GeGLU, tied embeddings): (a) ``init_params`` with its count;
   (b) ``generate`` on 2 seeded prompts of 6 144 tokens (the window binds
   from position 4 096 on) with 64 greedy steps: the prefill's time and
   tokens/s, the decode steps' ms and tokens/s, a profiled prefill and
   decode step with their idle shares and device ms by kernel, the peak
   memory; (c) ``flash_attention`` on layer 0's q, k and v in float32
   against a full softmax over materialised, masked scores, windowed and
   global with the softcap, within 1e-4 of max |out|; (d) the first
   decode step's logits against ``forward`` on the extended sequence,
   and the prefill's last logits against ``forward``'s, within twice
   bfloat16's own spread; (e) greedy twice equal, 16 sampled steps in
   range and unlike greedy.  qwen2.5-14b (48 layers, 14 770 033 664
   parameters; q, k, v biases, theta 1e6, untied): (f) the same (a), (b)
   on 2 prompts of 2 048 tokens with 16 steps, and (d);
14. the model stack: the MoE and MLA family and the hybrid at full
   width, random weights drawn on the card from a seed, served by
   ``Generator`` on 2 seeded prompts of 2 048 tokens: granite-moe-3b at
   full depth (32 layers, 3 903 186 432 parameters; 40 experts padded to
   48, top 8), deepseek-v2-236b at 3 of its 60 layers (12 964 930 560
   parameters; MLA, 160 experts top 6, 2 shared) and jamba-v0.1-52b at
   one of its 4 blocks (8 layers, 13 295 235 072 parameters; 7 Mamba and
   1 attention layer, MoE on every other).  Each: (a) ``init_params``
   with its count; (b) ``generate`` (32 greedy steps for granite, 16 for
   the others): the prefill's time and tokens/s, the decode steps' ms and
   tokens/s, a profiled prefill and decode step with their idle shares
   and device ms by kernel, the peak memory, ``ssm_scan`` once a Mamba
   layer in the prefill (jamba: 7) and never in decode, no other kernel
   of the repo, and the (token, choice) pairs the prefill's MoE layers
   drop at capacity factor 1.25 (the reference's rule, reported); (c) the
   first MoE layer in float32 on the normed prompt embeddings against a
   plain loop over the experts: the same kept pairs, within 1e-4 of max
   |out|, each timed; (f) deepseek's layer-0 MLA in float32: the
   absorbed decode of the last token over the latent cache against the
   expanded form's last row, within 1e-4 of max |out|, and the cache's
   576 values a token and a layer; (d) on the first 1 024 tokens, at the
   capacity factor that drops nothing (E_pad / k), the first decode
   step's logits against ``forward`` on the extended sequence and the
   prefill's last logits against ``forward``'s, within twice bfloat16's
   own spread; (e) greedy twice equal, 16 sampled steps in range and
   unlike greedy; (g) deepseek-v2-236b through a (1, 4) ``model`` mesh of
   the one card: the first MoE layer in float32 (each position's 40
   experts and its quarter of the 2 shared experts' width) against
   ``mesh=None`` within 1e-4 of max |out|, and a prefill of the 2
   prompts against its own without the mesh, the last logits within
   twice bfloat16's own spread, each prefill timed twice in turns after a
   warm-up;
15. the model stack: the front ends at full width and depth, random
   weights drawn on the card from a seed, served by ``Generator`` (no
   kernel of the repo runs: the reference's M-RoPE, encoder and
   cross-attention are plain ``jnp``).  qwen2-vl-7b (28 layers,
   7 615 616 512 parameters; M-RoPE sections (16, 24, 24), q, k, v
   biases): (a) ``init_params`` with its count, then ``generate`` on 2
   seeded prompts of 2 048 tokens whose first 256 positions are seeded
   patch embeddings (a 448 x 448 image's 16 x 16 merged patches) with 32
   greedy steps, timed and profiled as in phase 13; (b) the prefill at
   Qwen2-VL's grid positions ((0, i // 16, i % 16) for the patches, 16 +
   j in every stream for the text) moves the logits against the default
   positions, ``apply_rope`` at those positions within float32's error
   of its float64 evaluation, and a decode step against ``forward`` on
   the grid positions within twice bfloat16's own spread.
   whisper-medium (24 encoder and 24 decoder layers, 1 013 989 376
   parameters), every norm weight drawn as 1 + 0.02 N(0, 1) and bias as
   0.02 N(0, 1) (the init rule zeroes them, and whisper then computes
   zeros: ROADMAP R9): (c) ``encode`` of 2 x 1 500 seeded frames timed
   and profiled alone, ``generate`` on 2 prompts of 224 tokens with
   ``max_len`` 448 and 64 greedy steps, timed and profiled, and a decode
   step sharing ``xk``, ``xv`` with the cache it was given (the same
   ``data_ptr``) while it copies the rest; (d) a decode step against
   ``forward`` as in (b);
16. training: (a) falcon-mamba-7b at full width cut to TRAIN_LAYERS (32)
   of 64 layers (3 902 672 896 parameters, 58.15 GiB of parameters,
   gradients and AdamW moments), B = 2, S = 4 096 (the reference's
   ``train_4k`` sequence), a warm-up step and three ``make_train_step``
   steps on one seeded batch: each step's wall, tokens/s, the losses
   (the last under the first), the peak memory (under 70 GiB), ``ssm_scan``
   twice a layer (the forward and the recompute) and ``ssm_scan_bwd`` once
   a layer a step and no other kernel of the repo, a profiled step (device
   ms by kernel, the idle share), layer 0's ``a_log`` moved (its gradient
   comes only through the scan); (b) smollm-360m at full size, B = 4, S =
   2 048, one step with microbatches 2 against 1 at the reference's own
   tolerances; (c) ``launch.train.main --aba-batching`` on smollm-360m at
   full size, 6 steps straight against 3, a checkpoint and a resume: the
   last loss bitwise equal; (d) ``--grad-compression --dp 2`` on the one
   card.  Phase 2 holds ``ssm_scan_bwd`` to ``ssm_scan_bwd_ref`` at (a)'s
   layer shape (2, 4 096, 8 192, 16) and times it, its two grids apart
   and in turns with the previous design (commit SSM_BWD_PARENT's source,
   built outside the tree), and holds both and the float32 plain walk to
   the plain walk in float64;
17. the launch layer (budget 60 s, its time printed): (a) every config's
   ``Model`` on ``meta`` with its parameter count and bytes, equal to
   ``abstract_params``'; (b) granite-moe-3b at full width and depth (3
   903 186 432 parameters) through ``make_host_mesh(1, 4,
   device="cuda")`` against ``mesh=None`` on the same weights and batch
   (B = 2, S = 2 048): the first MoE layer in float32 within 1e-4 of max
   |out|; after a warm-up of each, ``lm_loss`` and its gradients in
   bfloat16 within twice bfloat16's own spread (their distance from the
   float32-compute loss and gradients), the gradients by their global
   norm; a warm-up step and ``make_train_step`` steps with and without
   the mesh in turns, each timed, the peak under 70 GiB; (c) five
   ``launch.dryrun.run_cell`` cells on ``meta`` in child processes that
   see no card, started at the phase's start: smollm-360m ``train_4k``, deepseek-v2-236b
   ``prefill_32k`` at 2x16x16, falcon-mamba-7b ``long_500k``,
   qwen2.5-14b ``decode_32k`` and ``aba-pipeline``, each record a line of
   its own; (c') the ``aba_1m`` cell run on the card: 2^20 x 192 rows of
   ``make("lowrank", ..., seed=0)`` (drawn in a thread from the phase's
   start), k = 8 192, ``fixed_rounds=320``, through ``sharded_core`` over
   the production mesh's 16 data shards, every position ``cuda:0``:
   exact balance, its wall and launches;

then one JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises, exits non-zero and
prints no last line.  Needs one CUDA device; fails without one.

    python3 chip_smoke.py --bid-top2-bits

prints only the digests of ``bid_top2``'s bits at phase 2's shapes, as one
JSON line, and exits.  It imports nothing that the kernel's earlier trees
lack, so a copy of this script in another checkout gives that tree's
digests: equal digests are equal bits.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import importlib
import inspect
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import incremental, obs  # noqa: E402
from repro_torch.anticluster import (AnticlusterEngine,  # noqa: E402
                                     ShardedABAState, anticluster)
from repro_torch.core import assignment as asg  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.aba import (_MASK_COST, _centrality,  # noqa: E402
                                  aba_core, aba_stream)
from repro_torch.core.hierarchical import _regroup  # noqa: E402
from repro_torch.core.kplus import kplus_augment, moment_spread  # noqa: E402
from repro_torch.core.objective import (  # noqa: E402
    balance_ok, diversity_per_cluster, objective_centroid)
from repro_torch.data import (ABABatchSequencer, aba_folds,  # noqa: E402
                              fold_engine, fold_partition, fold_splits,
                              minibatch)
from repro_torch.data.synthetic import (PRESETS, lm_token_stream,  # noqa: E402
                                        make)
import repro_torch.kernels as K  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import auction_phase as phase_kernel  # noqa: E402
from repro_torch.kernels.bid_top2 import bid_top2 as cuda_bid_top2  # noqa: E402
from repro_torch.kernels.cdist import cdist as cuda_cdist  # noqa: E402
from repro_torch.kernels.gather import (  # noqa: E402
    STAGES as GATHER_STAGES, bid_top2_gather as cuda_bid_top2_gather,
    bid_top2_gather_prev, bid_top2_gather_timed,
    cdist_gather as cuda_cdist_gather, gather_rows as cuda_gather_rows)
from repro_torch.kernels.ref import (  # noqa: E402
    bid_top2_gather_ref, bid_top2_ref, cdist_gather_ref, cdist_ref,
    gather_rows_ref, ssm_scan_bwd_ref, ssm_scan_chunk_ref, ssm_scan_ref)
from repro_torch.kernels.ssm_scan import (  # noqa: E402
    ssm_scan_bwd, ssm_scan_chunk, ssm_scan_train, workspace_floats)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as ML  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import registry as model_registry  # noqa: E402
from repro_torch.models import transformer as MT  # noqa: E402
from repro_torch.serve import Generator  # noqa: E402
from repro_torch.serve import AnticlusterRouter  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import ABAPipeline  # noqa: E402
from repro_torch.train import (OptConfig, adamw_init,  # noqa: E402
                               make_train_step)

# the module, not the function the package exports under its name
bid_top2_module = importlib.import_module("repro_torch.kernels.bid_top2")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores.  Beside them, for ssm_scan's log line only: the SMs, the
# special-function unit's exp2 (MUFU.EX2) rate, 16 a clock an SM, and the
# boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SMS = 132
EX2_PER_CLOCK_PER_SM = 16
BOOST_SM_MHZ = 1980
PROFILE_BATCHES = 4  # batches of the profiled run (the first has no LAP)
CHECK_LAPS = 65  # LAPs of the main data held against the Python loop
TIMED_LAPS = 16  # LAPs of the main data whose rounds are timed
WINDOW_LAPS = 20  # LAPs of a profiled window in the middle of a call
# bidder counts of a round, as PERF.md tabulates them
BUCKETS = (("1", 1, 1), ("2-4", 2, 4), ("5-32", 5, 32), (">32", 33, 1 << 30))


T_START = time.perf_counter()


def log(msg: str):
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name} (at {time.perf_counter() - T_START:.1f} s)")


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` calls of CUDA-event time around one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, name: str, reps: int = 20) -> float | None:
    """Mean device time of the kernels named ``name`` per call, from the
    profiler; None where it records no device activity in three profiled
    runs (one run sometimes records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(_self_device_us(e) for e in prof.key_averages()
                 if _is_kernel(e) and name in e.key)
        if us:
            return us / reps / 1e3
    return None


def launch_device_ms(fn, name: str, reps: int = 20):
    """Mean device time of one launch of the kernel named ``name``, from the
    profiler, and the launches it recorded of the ``reps`` calls made: the
    recorded time over the recorded launches, so a run that drops events
    (phase 5's have) still reads right.  (None, 0) where three profiled runs
    record none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if _is_kernel(e) and name in e.key]
        n = sum(e.count for e in hits)
        if n:
            return sum(_self_device_us(e) for e in hits) / n / 1e3, n
    return None, 0


def _self_device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _is_kernel(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    for name in _build.launches:
        _build.launches[name] = 0
    ref.rounds_executed = 0
    ref.reset_bid_totals()
    phase_kernel.reset_totals()


def counts() -> dict:
    """Launches per kernel, and the bidding rounds of the Python loop and
    of the phase kernels (read from the card; ``plain_rounds``: the loop's
    alone) with the kernels' bids and rounds with a single bidder."""
    kernel = phase_kernel.totals()
    return {**_build.launches, "rounds": ref.rounds_executed
            + kernel["rounds"], "plain_rounds": ref.rounds_executed,
            "bids": kernel["bids"],
            "single_bidder_rounds": kernel["single_bidder_rounds"]}


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def bid_inputs(gen, G, m, k, d, integer, dev):
    if integer:
        def r(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen).float().to(dev)
        return r(-2, 3, (G, m, d)), r(-1, 2, (G, k, d)), r(-2, 3, (G, k))
    return (torch.randn((G, m, d), generator=gen).to(dev),
            torch.randn((G, k, d), generator=gen).to(dev),
            torch.randn((G, k), generator=gen).to(dev))


# The shapes phase 2 holds bid_top2 and the span's pair to their plain
# versions at (G, m, k, d): the auction's, d on the 16-byte grid, a stack,
# uneven tiles, k past one pass, k and d past what stays in shared memory,
# and the hierarchical route's level-2 span (G = 64 LAPs of n = 64).
BID_TOP2_SHAPES = [(1, 256, 256, 22), (1, 256, 256, 32), (4, 256, 256, 32),
                   (1, 37, 37, 5), (1, 256, 513, 22), (1, 64, 513, 200),
                   (64, 64, 64, 32)]


def check_bid_top2(dev) -> float:
    """One call and the span's pair (bid_top2_span) against their plain
    versions at each shape: exact on integers, to :func:`top2_err`'s
    tolerance on floats.  Returns one call's float max error at the main
    shape."""
    gen = torch.Generator().manual_seed(0)
    main_err = None
    for G, m, k, d in BID_TOP2_SHAPES:
        at = f"G={G} m={m} k={k} d={d}"
        x, c, p = bid_inputs(gen, G, m, k, d, True, dev)
        equal(cuda_bid_top2(x, c, p), bid_top2_ref(x, c, p),
              f"bid_top2 on integers at {at}")
        for got, want in zip(bid_top2_module.bid_top2_span(x, c),
                             ref.bid_top2_span_ref(x, c)):
            equal(got, want, f"the span pair on integers at {at}")
        x, c, p = bid_inputs(gen, G, m, k, d, False, dev)
        err = top2_err(cuda_bid_top2(x, c, p), bid_top2_ref(x, c, p),
                       f"bid_top2 at {at}")
        span_err = max(top2_err(got, want, f"the span pair at {at}")
                       for got, want in zip(bid_top2_module.bid_top2_span(x, c),
                                            ref.bid_top2_span_ref(x, c)))
        log(f"bid_top2 and the span pair {at}: integers exact, floats "
            f"max_abs_err={err:.3e} (pair {span_err:.3e}), argmax equal "
            f"where the top-2 gap > 1e-4*scale")
        if (G, m, k, d) == (1, 256, 256, 22):
            main_err = err
    return main_err


def bid_top2_bits(dev) -> dict:
    """sha256 (16 hex digits) of the CUDA bid_top2's v1, j1 and v2 bytes on
    seeded Gaussian floats at each of phase 2's shapes: two trees whose
    digests are equal gave the same bits."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for G, m, k, d in BID_TOP2_SHAPES:
        x = torch.randn((G, m, d), generator=gen).to(dev)
        c = torch.randn((G, k, d), generator=gen).to(dev)
        p = torch.randn((G, k), generator=gen).to(dev)
        h = hashlib.sha256()
        for t in cuda_bid_top2(x, c, p):
            h.update(t.cpu().numpy().tobytes())
        out[f"G={G} m={m} k={k} d={d}"] = h.hexdigest()[:16]
    return out


def off_grid(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose data starts 4 bytes off the 16-byte grid, which
    the TMA's bulk copy needs: the kernels stage it by their threads."""
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    shifted = shifted.view(t.shape).copy_(t)
    check(shifted.data_ptr() % 16 != 0, "off_grid gave an aligned copy")
    return shifted


def measure_bid_top2(dev, single_err) -> dict:
    """bid_top2 as the main path launches it: the span's pair in one launch
    (x at zero prices, -x at 2||c||^2) at G=1 m=k=256 d=22.  Beside it, one
    call at the same shape, the two calls the pair replaces, and one call
    with c off the 16-byte grid (the threads' staging, not the TMA)."""
    G, m, k, d = 1, 256, 256, 22
    gen = torch.Generator().manual_seed(1)
    x, c, p = bid_inputs(gen, G, m, k, d, False, dev)
    cn = (c * c).sum(dim=-1)
    pn = 2.0 * cn

    def pair():
        return bid_top2_module.bid_top2_span(x, c)

    def plain_pair():
        return ref.bid_top2_span_ref(x, c)

    err = max(top2_err(got, want, "the span pair")
              for got, want in zip(pair(), plain_pair()))
    xx, bias2 = torch.cat((x, -x)), torch.stack((cn, -cn))

    def library():  # yardstick only: one batched GEMM with the bias, topk(2)
        return torch.topk(torch.baddbmm(bias2, xx, c.mT.expand(2, d, k),
                                        alpha=-2.0), 2, dim=-1)

    def two_calls():
        cuda_bid_top2(x, c, torch.zeros_like(pn))
        cuda_bid_top2(-x, c, pn)

    row = {"name": "bid_top2", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/bid_top2.cu",
           "replaces": "src/repro/kernels/bid_top2.py:33",
           "shape": f"G={G} m={m} k={k} d={d}, the span's pair in one launch",
           "max_abs_err": err, "ms": time_ms(pair),
           "device_ms": device_ms(pair, "bid_top2_kernel"),
           "plain_ms": time_ms(plain_pair), "library_ms": time_ms(library),
           "library_device_ms": device_ms(library, ""),
           "two_calls_device_ms": device_ms(two_calls, "bid_top2_kernel")}
    row["bound_ms"], row["bound_by"] = bound_ms(
        4 * (m * d + k * d) + 2 * m * (4 + 8 + 4),
        2 * 2 * m * k * d + 2 * k * d)
    # one call, as the entry point makes it, and with c off the grid
    x1, c1, p1 = x[0], c[0], p[0]
    bias = cn[0] - p1
    c_staged = off_grid(c1)
    b1, _ = bound_ms(4 * (m * d + k * d + k) + m * (4 + 8 + 4),
                     2 * m * k * d + 2 * k * d)
    row.update(
        single_max_abs_err=single_err,
        single_ms=time_ms(lambda: cuda_bid_top2(x1, c1, p1)),
        single_device_ms=device_ms(lambda: cuda_bid_top2(x1, c1, p1),
                                   "bid_top2_kernel"),
        single_bound_ms=b1,
        single_plain_ms=time_ms(lambda: bid_top2_ref(x1, c1, p1)),
        single_library_ms=time_ms(lambda: torch.topk(
            torch.addmm(bias, x1, c1.T, alpha=-2.0), 2, dim=1)),
        single_library_device_ms=device_ms(lambda: torch.topk(
            torch.addmm(bias, x1, c1.T, alpha=-2.0), 2, dim=1), ""),
        staged_device_ms=device_ms(lambda: cuda_bid_top2(x1, c_staged, p1),
                                   "bid_top2_kernel"))
    log(f"bid_top2 one call (G=1 m=k={m} d={d}): {row['single_ms']:.4f} ms "
        f"(device {row['single_device_ms']} ms; c off the 16-byte grid, "
        f"staged by the threads: device {row['staged_device_ms']} ms), "
        f"bound {b1:.7f} ms, addmm + topk(2) device "
        f"{row['single_library_device_ms']} ms; the span's pair in one "
        f"launch device {row['device_ms']} ms, as two calls device "
        f"{row['two_calls_device_ms']} ms (the -x not counted)")
    return row


def check_and_measure_gather(dev) -> dict:
    n, m, d = PRESETS["diabetes"][0], 8192, PRESETS["diabetes"][1]
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((n, d), generator=gen).to(dev)
    idx = torch.randint(-100, n + 100, (m,), generator=gen).to(dev)
    for index in (idx, idx.int()):
        got, want = cuda_gather_rows(x, index), gather_rows_ref(x, index)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"gather_rows differs ({index.dtype})")
    for dd in (1, 3, 32, 33, 200):  # 4-, 8- and 16-byte words, 1..32 lanes
        xd = torch.randn((4099, dd), generator=gen).to(dev)
        shifted = torch.randn((4099 * dd + 1,), generator=gen).to(dev)[1:]
        for src in (xd, shifted.view(4099, dd)):  # aligned, and 4 bytes off
            check(torch.equal(cuda_gather_rows(src, idx),
                              gather_rows_ref(src, idx)),
                  f"gather_rows d={dd} differs")
    log(f"gather_rows n={n} m={m} d={d} (clipped int64 and int32 indices) "
        f"and d=1/3/32/33/200 from aligned and unaligned rows: bitwise equal")
    clipped = idx.clamp(0, n - 1)
    # in turns: kernel, library, library, kernel
    ms_a = time_ms(lambda: cuda_gather_rows(x, idx))
    lib_a = time_ms(lambda: torch.index_select(x, 0, clipped))
    lib_b = time_ms(lambda: torch.index_select(x, 0, clipped))
    ms_b = time_ms(lambda: cuda_gather_rows(x, idx))
    dms = device_ms(lambda: cuda_gather_rows(x, idx),
                    "gather_rows_kernel")
    # every kernel the call launches: its name varies with the PyTorch version
    lib_dms = device_ms(lambda: torch.index_select(x, 0, clipped), "")
    plain = time_ms(lambda: gather_rows_ref(x, idx))
    log(f"gather_rows vs index_select, event ms in turns: {ms_a:.4f} / "
        f"{lib_a:.4f} / {lib_b:.4f} / {ms_b:.4f}; device ms {dms} vs "
        f"{lib_dms}")
    b, by = bound_ms(2 * 4 * m * d + 8 * m, 0)
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/gather.py:69",
            "shape": f"n={n} m={m} d={d}", "max_abs_err": 0.0,
            "ms": min(ms_a, ms_b), "device_ms": dms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": min(lib_a, lib_b),
            "library_device_ms": lib_dms}


class PhaseRecorder:
    """Within the block every call of the dispatcher ``ops.<name>``
    (``auction_phase``: the factored solver's phases; ``auction_phase_dense``:
    the dense solver's LAPs) runs as usual and is recorded: its arguments by
    name, outputs and the kernel's rounds, bids and single-bidder rounds (a
    sync per phase: checks only).  With ``keep`` only the calls for whose
    arguments it returns True are recorded; the others run untouched."""

    def __init__(self, name: str = "auction_phase", keep=None):
        self.name = name
        self.keep = keep
        self.calls = []

    def __enter__(self):
        self.inner = getattr(ops, self.name)
        signature = inspect.signature(self.inner)

        def recorded(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            kw = dict(bound.arguments)
            # the kernel's arguments: whether the solver asked for the
            # rounds is not one
            kw.pop("return_rounds", None)
            if self.keep is not None and not self.keep(kw):
                return self.inner(*args, **kwargs)
            kw["prices"] = kw["prices"].clone()
            t0 = phase_kernel.totals()
            out = self.inner(*args, **kwargs)
            t1 = phase_kernel.totals()
            self.calls.append({"kw": kw, "out": out,
                               **{key: t1[key] - t0[key] for key in t1}})
            return out

        setattr(ops, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(ops, self.name, self.inner)


def loop_over_bid_top2(x, c, is_real, prices, eps, max_rounds,
                       fixed_rounds=0, skip=None, seed_top2=None):
    """The Python round loop over the CUDA bid_top2 kernel: the port's
    phase before the phase kernel."""
    return ref.auction_rounds(ref.factored_top2(x, c, is_real, cuda_bid_top2),
                              prices, eps, max_rounds, fixed_rounds, skip,
                              seed_top2)


def python_loop(kw, check_every=1, loop=loop_over_bid_top2):
    """A phase by the Python round loop (by default over the CUDA bid_top2
    kernel; ``ref.auction_phase_dense_ref`` for a dense phase), its
    predicate tested every ``check_every`` rounds; returns (assign, prices,
    counts): its rounds, bids and single-bidder rounds."""
    saved, ref._CHECK_EVERY = ref._CHECK_EVERY, check_every
    r0, b0 = ref.rounds_executed, ref.bid_totals()
    try:
        a, p = loop(**kw)
    finally:
        ref._CHECK_EVERY = saved
    b1 = ref.bid_totals()
    return a, p, {"rounds": ref.rounds_executed - r0,
                  **{key: b1[key] - b0[key] for key in b1}}


def check_phase_calls(calls, what, loop=loop_over_bid_top2,
                      kernel="auction_phase") -> int:
    """Each recorded kernel phase against the every-round Python loop:
    assignments and prices bitwise, rounds, bids and single-bidder rounds
    equal.  Returns the phases checked."""
    for i, call in enumerate(calls):
        a, p, loop_counts = python_loop(call["kw"], loop=loop)
        got_a, got_p = call["out"][:2]
        check(torch.equal(got_a, a) and torch.equal(got_p, p),
              f"{kernel} differs from the Python loop: {what}, phase {i}")
        for key, want in loop_counts.items():
            check(call[key] == want, f"{kernel} ran {call[key]} {key}, "
                  f"the Python loop {want}: {what}, phase {i}")
    return len(calls)


def check_auction_phase(dev) -> list:
    """The phase kernel against the Python loop over the bid_top2 kernel,
    bitwise: every phase of the first CHECK_LAPS LAPs of the main data (the
    last with 16 dummy rows), then a G = 3 warm stack with skip and
    seed_top2, fixed_rounds, a max_rounds cap that bites, and n = 512 with
    d = 200 (x and c in device memory).  Returns the main data's phases."""
    n, d, _ = PRESETS["diabetes"]
    k = 256
    rows = (CHECK_LAPS + 1) * k - 16
    x = torch.from_numpy(make("mixture", n, d, seed=0)[:rows]).to(dev)
    with PhaseRecorder() as rec:
        aba_stream(x, k, 8192, solver="auction_fused", device=dev)
    check(len(rec.calls) == 4 * CHECK_LAPS, f"{len(rec.calls)} phases")
    check_phase_calls(rec.calls, "main data")
    laps = rec.calls
    log(f"auction_phase: {len(laps)} phases of the first {CHECK_LAPS} LAPs "
        f"of the main data (n={k} d={d}, the last LAP with 16 dummy rows): "
        f"assignments and prices bitwise equal to the every-round Python "
        f"loop over bid_top2; rounds, bids and single-bidder rounds equal")

    def lap(i, p):
        return laps[4 * i + p]["kw"]
    last = CHECK_LAPS - 1
    dummies = [int((~lap(i, 0)["is_real"]).sum())
               if lap(i, 0)["is_real"] is not None else 0 for i in (0, last)]
    check(dummies[0] == 0 and dummies[-1] > 0, f"dummy rows {dummies}")
    check_span([lap(0, 0), lap(last, 0)],
               f"the main data (dummy rows {dummies})")
    xs = torch.stack([lap(i, 0)["x"][0] for i in (0, 1, last)])
    cs = torch.stack([lap(i, 0)["c"][0] for i in (0, 1, last)])
    real = torch.ones((3, k), dtype=torch.bool, device=dev)
    real[2] = lap(last, 0)["is_real"][0]
    warm = torch.stack([laps[4 * i + 3]["out"][1][0] for i in (0, 1, last)])
    cfgs = {
        "G=3 warm, skip, seed": asg.AuctionConfig(),
        "G=3 fixed_rounds=60": asg.AuctionConfig(fixed_rounds=60),
        "G=3 max_rounds=5": asg.AuctionConfig(max_rounds=5),
    }
    checked = 0
    for what, cfg in cfgs.items():
        with PhaseRecorder() as rec:
            asg.auction_solve_factored(
                xs, cs, is_real=real, config=cfg, device=dev,
                prices=warm if "warm" in what else None)
        if "warm" in what:
            skips = [c["kw"]["skip"] for c in rec.calls]
            check(any(s is not None and bool(s.any()) for s in skips)
                  and rec.calls[0]["kw"]["seed_top2"] is not None,
                  "the warm stack skipped no phase")
        checked += check_phase_calls(rec.calls, what)
    gen = torch.Generator().manual_seed(7)
    xw = torch.randn((1, 512, 200), generator=gen).to(dev)
    cw = torch.randn((1, 512, 200), generator=gen).to(dev)
    with PhaseRecorder() as rec:
        asg.auction_solve_factored(xw, cw, device=dev)
    checked += check_phase_calls(rec.calls, "n=512 d=200")
    # n = 8192: the per-row state lives in device memory too; the first
    # phase, to its end and cut by a cap
    xb = torch.randn((1, 8192, 5), generator=gen).to(dev)
    cb = torch.randn((1, 8192, 5), generator=gen).to(dev)
    eps = torch.full((1,), 2.0, device=dev)
    big = []
    for cap in (50 * 8192 + 1000, 40):
        with PhaseRecorder() as rec:
            ops.auction_phase(xb, cb, None, torch.zeros((1, 8192), device=dev),
                              eps, cap)
        checked += check_phase_calls(rec.calls, f"n=8192 max_rounds={cap}")
        big.append(rec.calls[0]["rounds"])
    log(f"auction_phase: {checked} more phases bitwise equal with equal "
        f"rounds, bids and single-bidder rounds: {', '.join(cfgs)}, n=512 "
        f"d=200, n=8192 d=5 (state in "
        f"device memory; {big[0]} rounds to the end, cut at {big[1]})")
    return laps


def check_span(phases, what) -> float:
    """The span's pair in one launch on the LAPs of the given phases: slot
    0 bitwise one bid_top2 call at zero prices, both slots against the
    plain pair to :func:`top2_err`'s tolerance.  Returns the max error."""
    err = 0.0
    for kw in phases:
        x, c = kw["x"], kw["c"]
        pair = bid_top2_module.bid_top2_span(x, c)
        equal(pair[0], cuda_bid_top2(x, c, x.new_zeros(c.shape[:2])),
              f"the span's slot 0 on {what}")
        for got, want in zip(pair, ref.bid_top2_span_ref(x, c)):
            err = max(err, top2_err(got, want, f"the span pair on {what}"))
    shapes = sorted({tuple(kw["x"].shape) for kw in phases})
    log(f"bid_top2 span pair (one launch) on {len(phases)} LAPs of {what} "
        f"(x {shapes}): slot 0 bitwise one bid_top2 call, both slots within "
        f"bid_top2's tolerance of the plain pair (max_abs_err {err:.3e})")
    return err


def measure_auction_phase(dev, laps) -> dict:
    """One LAP of the main data (its four phases) by the kernel and by the
    Python loop over bid_top2 as the parent ran it (predicate every
    _CHECK_EVERY rounds); the bound from the LAP's counted bids."""
    lap = laps[4:8]  # the second LAP
    x = lap[0]["kw"]["x"]
    _, n, d = x.shape

    def kernel():
        for call in lap:
            phase_kernel.auction_phase(**call["kw"])

    def loop():
        for call in lap:
            loop_over_bid_top2(**call["kw"])

    ms = time_ms(kernel)
    dms = device_ms(kernel, "auction_phase_kernel")
    plain = time_ms(loop, reps=3, warmup=1)
    bids = sum(c["bids"] for c in lap)
    rounds = sum(c["rounds"] for c in lap)
    # per phase: x, c, prices and eps in; assignment (int64), prices out
    n_bytes = 4 * (4 * (2 * n * d + n + 1) + 12 * n)
    n_ops = bids * n * 2 * d + 4 * n * 2 * d
    b, by = bound_ms(n_bytes, n_ops)
    log(f"auction_phase one LAP (4 phases, {rounds} rounds, {bids} bids): "
        f"kernel {ms:.4f} ms (device {dms} ms), Python loop over bid_top2 "
        f"{plain:.2f} ms, bound {b:.6f} ms ({by})")
    return {"name": "auction_phase", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/auction_phase.cu",
            "replaces": "src/repro/core/assignment.py:115 (the lax.while_loop "
                        "of _auction_phase; no pallas_call)",
            "shape": f"one LAP: 4 phases, G=1 n={n} d={d}, {rounds} rounds, "
                     f"{bids} bids",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None}


def dense_inputs(gen, G, n, integer, dev):
    """A (G, n, n) cost stack (integers in [-3, 3], or Gaussian floats
    times 5) with the last group's last quarter of rows zeroed, as
    ``_assign_batch`` zeroes dummy rows."""
    if integer:
        cost = torch.randint(-3, 4, (G, n, n), generator=gen).float()
    else:
        cost = torch.randn((G, n, n), generator=gen) * 5
    cost[-1, n - n // 4:] = 0.0
    return cost.to(dev)


def check_auction_phase_dense(dev) -> list:
    """The dense phase kernel against the Python loop over ``ref.top2``,
    bitwise, phase after phase, with equal rounds, bids and single-bidder
    rounds: the launch of each of the first CHECK_LAPS LAPs of the main
    data on the default spec's flat route (all four phases; the cost as
    ``_assign_batch`` builds it; the last LAP with 16 dummy rows), then a
    G = 3 stack of three of those LAPs warm (skips, seed), with
    fixed_rounds and with a max_rounds cap that bites, integer costs
    (ties), n = 100 and 250 (staged by the threads), n = 1, n = 512
    (max_k) and n = 8192 (the per-row state in device memory).  Returns
    the main data's launches."""
    n, d, _ = PRESETS["diabetes"]
    k = 256
    rows = (CHECK_LAPS + 1) * k - 16
    x = torch.from_numpy(make("mixture", n, d, seed=0)[:rows]).to(dev)
    with PhaseRecorder("auction_phase_dense") as rec:
        res = anticluster(x, k=k, device=dev)
    check(res.route == "flat" and res.solver == "auction",
          f"route {res.route} solver {res.solver}")
    check(len(rec.calls) == CHECK_LAPS
          and all(c["kw"]["eps"].shape == (4, 1) for c in rec.calls),
          f"{len(rec.calls)} launches, not one a LAP of four phases")
    laps = rec.calls
    last = CHECK_LAPS - 1
    lap_cost = laps[last]["kw"]["cost"]
    dummy_rows = int((lap_cost[0].abs().sum(1) == 0).sum())
    check(dummy_rows == 16, f"the last LAP has {dummy_rows} zero cost rows")
    loop = ref.auction_phase_dense_ref
    what = "auction_phase_dense"
    check_phase_calls(laps, "main data", loop, what)
    log(f"auction_phase_dense: {len(laps)} launches, all 4 phases of each "
        f"of the first {CHECK_LAPS} LAPs of the main data on the flat route "
        f"(n={k}, the cost of _assign_batch, the last LAP with {dummy_rows} "
        f"dummy rows): assignments and prices bitwise equal to the "
        f"every-round Python loop over top2, phase after phase; rounds, bids "
        f"and single-bidder rounds equal")

    costs = torch.cat([laps[i]["kw"]["cost"] for i in (0, 1, last)])
    warm = torch.cat([laps[i]["out"][1] for i in (0, 1, last)])
    gen = torch.Generator().manual_seed(9)
    cases = {
        "G=3 warm, skip, seed": (costs, asg.AuctionConfig(), warm),
        "G=3 fixed_rounds=60": (costs, asg.AuctionConfig(fixed_rounds=60),
                                None),
        "G=3 max_rounds=5": (costs, asg.AuctionConfig(max_rounds=5), None),
        "G=3 n=48 integers": (dense_inputs(gen, 3, 48, True, dev),
                              asg.AuctionConfig(), None),
        "G=3 n=48 integers warm": (dense_inputs(gen, 3, 48, True, dev),
                                   asg.AuctionConfig(),
                                   torch.randint(0, 4, (3, 48), generator=gen)
                                   .float().to(dev)),
        "n=512 floats": (dense_inputs(gen, 1, 512, False, dev),
                         asg.AuctionConfig(), None),
    }
    checked = 0
    for name, (cost, cfg, prices) in cases.items():
        with PhaseRecorder("auction_phase_dense") as rec:
            asg.auction_solve(cost, cfg, prices=prices, device=dev)
        if prices is not None:
            skips = [c["kw"]["skip"] for c in rec.calls]
            check(any(s is not None and bool(s.any()) for s in skips)
                  and rec.calls[0]["kw"]["seed_top2"] is not None,
                  f"{name}: the warm stack skipped no phase")
        checked += check_phase_calls(rec.calls, name, loop, what)
    # the residencies: every cost row staged (n = 100, off the float4 grid:
    # by the threads), 222 of 250 (by the threads); n = 512 above: 104
    for nn in (100, 250):
        cost = dense_inputs(gen, 2, nn, False, dev)
        with PhaseRecorder("auction_phase_dense") as rec:
            asg.auction_solve(cost, device=dev)
        checked += check_phase_calls(rec.calls, f"G=2 n={nn}", loop, what)
    # n = 1 (the solver never launches it: a direct call) and n = 8192,
    # the per-row state in device memory: to the end and cut by a cap
    direct = [("n=1", dense_inputs(gen, 2, 1, False, dev), 1000)]
    big = dense_inputs(gen, 1, 8192, False, dev)
    direct += [("n=8192", big, 50 * 8192 + 1000), ("n=8192", big, 40)]
    big_rounds = []
    for name, cost, cap in direct:
        G, nn = cost.shape[:2]
        with PhaseRecorder("auction_phase_dense") as rec:
            ops.auction_phase_dense(cost, torch.zeros((G, nn), device=dev),
                                    torch.full((1, G), 2.0, device=dev), cap)
        checked += check_phase_calls(rec.calls, f"{name} max_rounds={cap}",
                                     loop, what)
        if name == "n=8192":
            big_rounds.append(rec.calls[0]["rounds"])
    del big
    log(f"auction_phase_dense: {checked} more launches bitwise equal with "
        f"equal rounds, bids and single-bidder rounds: {', '.join(cases)}, "
        f"n=100, n=250, n=1, n=8192 (state in device memory; {big_rounds[0]} "
        f"rounds to the end, cut at {big_rounds[1]})")
    return laps


def measure_auction_phase_dense(dev, laps) -> dict:
    """One LAP of the main data on the flat route (its four dense phases,
    one launch) by the kernel and by the Python loop over top2 as the
    parent ran it (predicate every _CHECK_EVERY rounds); the bound from
    each input byte read once (the cost once a launch) and each output
    byte written once, or from the subtractions of the LAP's counted
    bids, the larger; beside it a latency floor: the LAP's rounds, each
    as short as the shortest round of this LAP's own trace from the timed
    instantiation, at the boost clock."""
    lap = laps[1:2]  # the second LAP
    n = lap[0]["kw"]["cost"].shape[1]
    P = lap[0]["kw"]["eps"].shape[0]

    def kernel():
        for call in lap:
            phase_kernel.auction_phase_dense(**call["kw"])

    def loop():
        for call in lap:
            ref.auction_phase_dense_ref(**call["kw"])

    ms = time_ms(kernel)
    dms = device_ms(kernel, "auction_phase_kernel")
    plain = time_ms(loop, reps=3, warmup=1)
    bids = sum(c["bids"] for c in lap)
    rounds = sum(c["rounds"] for c in lap)
    # the cost, prices and the (P, 1) schedule in; assignment (int64) and
    # prices out
    n_bytes = 4 * (n * n + n + P) + 12 * n
    b, by = bound_ms(n_bytes, bids * n)
    *out, trace = phase_kernel.auction_phase_dense_timed(
        **lap[0]["kw"], trace_rounds=rounds)
    check(torch.equal(out[0], lap[0]["out"][0])
          and torch.equal(out[1], lap[0]["out"][1]),
          "auction_phase_dense_timed differs on the timed LAP")
    cycles = trace[trace[:, 0] >= 0, 1].cpu()
    check(len(cycles) == rounds, f"the timed LAP traced {len(cycles)} of "
          f"its {rounds} rounds")
    shortest = int(cycles.min())
    floor = rounds * shortest / (BOOST_SM_MHZ * 1e3)
    log(f"auction_phase_dense one LAP ({P} phases in one launch, {rounds} "
        f"rounds, {bids} bids): kernel {ms:.4f} ms (device {dms} ms), "
        f"Python loop over top2 {plain:.2f} ms, bound {b:.6f} ms ({by}); "
        f"latency floor {rounds} rounds x {shortest} cycles (the LAP's "
        f"shortest round; median {float(cycles.median()):.0f}) at "
        f"{BOOST_SM_MHZ} MHz = {floor:.4f} ms")
    return {"name": "auction_phase_dense", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/auction_phase_dense.cu",
            "replaces": "src/repro/core/assignment.py:115 (the lax.while_loop "
                        "of _auction_phase over _top2_batched, :106; no "
                        "pallas_call)",
            "shape": f"one LAP: {P} phases in one launch, G=1 n={n}, "
                     f"{rounds} rounds, {bids} bids",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": None, "lap_rounds": rounds,
            "latency_floor_ms": floor, "shortest_round_cycles": shortest}


# ---------------------------------------------------------------------------
# Section 4.3: attributes, checks, and phase 2's masked LAPs
# ---------------------------------------------------------------------------

# The constrained calls' attributes: the CDC BRFSS 2015 table behind the
# *diabetes* shape (the diabetes_012 target's class counts; sex; age in 13
# bands), each a seeded permutation of its levels with these counts, scaled
# to the rows of a cut run.  PERF.md states their source.
ATTRIBUTE_COUNTS = {
    "class": (213703, 4631, 35346),
    "sex": (141974, 111706),
    "age": (5700, 7598, 11123, 13823, 16157, 19819, 26314, 30832, 33244,
            32194, 23533, 15980, 17363),
}
ATTRIBUTE_SEED = 7


def attributes(n: int, seed: int = ATTRIBUTE_SEED) -> dict:
    """The three attributes of n rows: int64 level codes whose counts are
    ATTRIBUTE_COUNTS scaled to n, each in a seeded order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, counts in ATTRIBUTE_COUNTS.items():
        c = np.asarray(counts) * n // sum(counts)
        c[np.argmax(c)] += n - c.sum()
        out[name] = rng.permutation(np.repeat(np.arange(len(c)), c))
    return out


def per_cluster(labels: np.ndarray, codes: np.ndarray, k: int):
    """(each level's count in each cluster (levels, k), each level's
    floor(|N|/k) and ceil(|N|/k))."""
    levels = codes.max() + 1
    cnt = np.bincount(codes * k + labels, minlength=levels * k)
    size = np.bincount(codes, minlength=levels)
    return cnt.reshape(levels, k), size // k, -(-size // k)


def stratified(labels, codes, k: int) -> bool:
    """Constraint (5): each level's count in every cluster within
    floor(|N|/k)..ceil(|N|/k)."""
    cnt, lo, hi = per_cluster(labels, codes, k)
    return bool((cnt.min(1) >= lo).all() and (cnt.max(1) <= hi).all())


def quota_excess(labels, codes, k: int) -> int:
    """The largest count of a level in a cluster above its quota
    ceil(|N|/k) (0 when every quota holds)."""
    cnt, _, hi = per_cluster(labels, codes, k)
    return int(max((cnt - hi[:, None]).max(), 0))


class MaskedLaps:
    """Within the block every dense LAP (one dispatch) is counted, and those
    whose cost holds the quota mask's ``_MASK_COST``: a read from the card
    a LAP, so checks only."""

    def __enter__(self):
        self.inner, self.last = ops.auction_phase_dense, None
        self.laps = self.masked = 0

        def counted(cost, *args, **kwargs):
            if cost is not self.last:
                self.last = cost
                self.laps += 1
                self.masked += bool((cost == _MASK_COST).any())
            return self.inner(cost, *args, **kwargs)

        ops.auction_phase_dense = counted
        return self

    def __exit__(self, *exc):
        ops.auction_phase_dense = self.inner
        self.last = None


def check_masked_dense(dev, n: int) -> dict:
    """The dense phase kernel on the masked LAPs of phase 7's call (b),
    ``anticluster(x, k=256, fairness={class, sex, age})`` on the main
    data: every phase of every LAP whose cost holds the quota mask, each
    with its own eps schedule (~1.25e8 down to ~1e6: ROADMAP fault R6),
    against the every-round Python loop over top2, bitwise, with equal
    rounds, bids and single-bidder rounds; then a G = 3 stack of three of
    them, warm, through the solver and as one phase with skip and seed.
    Then one masked LAP timed against one unmasked LAP of the same call,
    and the rounds of the masked LAPs and of TIMED_LAPS unmasked ones
    through the dense kernel's timed instantiation (the crossover)."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    with PhaseRecorder("auction_phase_dense") as rec:
        res = anticluster(x, k=k, device=dev, fairness=attributes(n))
    calls = rec.calls
    check(res.route == "flat" and res.solver == "auction"
          and len(calls) == -(-n // k) - 1,
          f"call (b): route {res.route} solver {res.solver}, "
          f"{len(calls)} launches")
    laps = [[call] for call in calls]  # one launch a LAP
    is_masked = [bool((lap[0]["kw"]["cost"] == _MASK_COST).any())
                 for lap in laps]
    masked = [lap for lap, m in zip(laps, is_masked) if m]
    unmasked = [lap for lap, m in zip(laps, is_masked) if not m][:TIMED_LAPS]
    del calls, rec, laps
    check(len(masked) > 0, "call (b) ran no masked LAP")
    loop = ref.auction_phase_dense_ref
    what = "auction_phase_dense"
    for i, lap in enumerate(masked):
        check_phase_calls(lap, f"masked LAP {i}", loop, what)
    eps = [float(lap[0]["kw"]["eps"][p, 0]) for lap in masked for p in (0, 3)]
    stats = {key: sum(c[key] for lap in masked for c in lap)
             for key in ("rounds", "bids", "single_bidder_rounds")}
    cells = [int((lap[0]["kw"]["cost"] == _MASK_COST).sum())
             for lap in masked]
    log(f"auction_phase_dense on the {len(masked)} masked LAPs of call (b) "
        f"(of {len(is_masked)}; {sum(cells)} masked cells, at most "
        f"{max(cells)} in one LAP; eps from {max(eps[0::2]):.4e} down to "
        f"{min(eps[1::2]):.4e}): all {4 * len(masked)} phases ({len(masked)} "
        f"launches) bitwise equal to the every-round Python loop over top2; "
        f"rounds, bids and single-bidder rounds equal: {stats}")

    pick = [masked[i] for i in sorted({0, len(masked) // 2,
                                       len(masked) - 1})]
    while len(pick) < 3:
        pick.append(pick[-1])
    costs = torch.cat([lap[0]["kw"]["cost"] for lap in pick])
    warm = torch.cat([lap[0]["out"][1] for lap in pick])
    checked = 0
    with PhaseRecorder("auction_phase_dense") as rec:
        asg.auction_solve(costs, prices=warm, device=dev)
        skip = torch.tensor([[True, False, False]], device=dev)
        ops.auction_phase_dense(costs, warm, torch.cat(
            [lap[0]["kw"]["eps"][3:] for lap in pick], dim=1), 50 * k + 1000,
            skip=skip, seed_top2=ref.dense_top2(costs)(warm))
    checked += check_phase_calls(rec.calls, "G=3 masked warm stack", loop,
                                 what)
    log(f"auction_phase_dense: {checked} launches on a G=3 stack of masked "
        f"LAPs, warm (the solver's adaptive re-entry over four phases, then "
        f"one phase with skip and seed), bitwise equal with equal counts")

    def time_lap(lap):
        def kernel():
            for call in lap:
                phase_kernel.auction_phase_dense(**call["kw"])
        return time_ms(kernel), device_ms(kernel, "auction_phase_kernel")

    one, plain_lap = masked[0], unmasked[0]
    ms, dms = time_lap(one)
    plain_ms, plain_dms = time_lap(plain_lap)
    counts_one = {key: sum(c[key] for c in one)
                  for key in ("rounds", "bids", "single_bidder_rounds")}
    counts_plain = {key: sum(c[key] for c in plain_lap)
                    for key in ("rounds", "bids", "single_bidder_rounds")}
    log(f"one masked LAP of call (b) (4 phases, one launch, {counts_one}): "
        f"kernel "
        f"{ms:.4f} ms (device {dms} ms); an unmasked LAP of the same call "
        f"({counts_plain}): {plain_ms:.4f} ms (device {plain_dms} ms)")
    timed = phase_kernel.auction_phase_dense_timed
    rounds_timed = {
        "masked": time_rounds([c for lap in masked for c in lap], timed,
                              f"the {len(masked)} masked LAPs of call (b)"),
        "unmasked": time_rounds([c for lap in unmasked for c in lap], timed,
                                f"the first {len(unmasked)} unmasked LAPs "
                                f"of call (b)")}
    return {"masked_laps": len(masked), "laps": len(is_masked),
            "masked_cells": sum(cells), "eps_hi": max(eps[0::2]),
            "eps_lo": min(eps[1::2]), "counts": stats,
            "warm_stack_phases": checked,
            "rounds_timed": rounds_timed,
            "masked_lap": {"ms": ms, "device_ms": dms, **counts_one},
            "unmasked_lap": {"ms": plain_ms, "device_ms": plain_dms,
                             **counts_plain},
            "labels_sha256": hashlib.sha256(
                res.labels.cpu().numpy().tobytes()).hexdigest()}


def time_rounds(calls, timed, what: str) -> dict:
    """Every recorded launch of ``calls`` through ``timed``, a phase kernel's
    timed instantiation, which stamps the SM clock around each round:
    under the kernel's own crossover ("rule"), with every round on the CTA
    path (threshold 0, "cta") and with every round of up to 32 bidders on
    the one-warp path ("warp").  Each launch is checked bitwise against
    the recorded one.  Logs the cycles a round by bidder bucket and the
    crossover, and where the kernel stages cost rows in shared memory (the
    dense one) the lone rounds on a staged row and on a row read from
    device memory, by the trace's last column; returns them."""
    runs = {}
    for name, threshold in (("rule", -1), ("cta", 0), ("warp", 32)):
        traces = []
        for i, call in enumerate(calls):
            a, p, trace = timed(**call["kw"], trace_rounds=call["rounds"],
                                threshold=threshold)
            check(torch.equal(a, call["out"][0])
                  and torch.equal(p, call["out"][1]),
                  f"{timed.__name__} ({name}) differs, phase {i}")
            traces.append(trace)
        trace = torch.cat(traces).cpu()
        runs[name] = trace[trace[:, 0] >= 0].numpy()
    bidders = runs["rule"][:, 0]
    check(all(np.array_equal(r[:, 0], bidders) for r in runs.values()),
          "the timed runs ran other rounds")

    def stats(rows):  # cycles a round, and the median of each step
        if not len(rows):
            return {"count": 0}
        return {"count": int(len(rows)), "median": float(np.median(rows[:, 1])),
                "p90": float(np.percentile(rows[:, 1], 90)),
                **{step: float(np.median(rows[:, col])) for step, col in
                   (("reduce", 3), ("post", 4), ("update", 5))}}

    table = {name: {label: stats(r[(r[:, 0] >= lo) & (r[:, 0] <= hi)])
                    for label, lo, hi in BUCKETS}
             for name, r in runs.items()}
    table["rule"]["all"] = stats(runs["rule"])
    # the two paths on the same rounds, by bidder count
    per_count = {}
    for b in range(1, 33):
        sel = bidders == b
        if sel.any():
            per_count[b] = {"rounds": int(sel.sum()),
                            "warp": float(np.median(runs["warp"][sel, 1])),
                            "cta": float(np.median(runs["cta"][sel, 1]))}
    measured = 0  # the most bidders below which the warp path always wins
    for b, row in per_count.items():
        if b != measured + 1 or row["warp"] >= row["cta"]:
            break
        measured = b
    rule = runs["rule"]
    in_warp = rule[rule[:, 2] == 1, 0]
    on_cta = rule[(rule[:, 2] == 0) & (rule[:, 0] <= 32), 0]
    chosen = {"warp_path_up_to": int(in_warp.max()) if len(in_warp) else 0,
              "cta_path_from": int(on_cta.min()) if len(on_cta) else None}
    log(f"{timed.__name__}: {len(bidders)} rounds of {len(calls)} phases "
        f"({what}), SM clock cycles a round by bidders (count / median / "
        f"p90 [median of the steps: top-2s / posting the bids / update]):")
    for name in runs:
        log(f"  {name:4s} " + "; ".join(
            f"{label}: {v['count']} / {v.get('median', 0):.0f} / "
            f"{v.get('p90', 0):.0f} [{v.get('reduce', 0):.0f} / "
            f"{v.get('post', 0):.0f} / {v.get('update', 0):.0f}]"
            for label, v in table[name].items())
            + f"; sum {int(runs[name][:, 1].sum())}")
    log("  median cycles by bidders, warp path / CTA path: " + ", ".join(
        f"{b}: {v['warp']:.0f} / {v['cta']:.0f}"
        for b, v in list(per_count.items())[:12]))
    by_row = {}
    if rule.shape[1] > 6 and rule[:, 6].any():  # where the row came from
        lone = rule[:, 0] == 1
        by_row = {"lone staged": stats(rule[lone & (rule[:, 6] == 1)]),
                  "lone unstaged": stats(rule[lone & (rule[:, 6] == 0)]),
                  ">32 share staged": float(
                      rule[rule[:, 0] > 32, 6].sum()
                      / max(1, rule[rule[:, 0] > 32, 0].sum()))}
        log("  by where the cost row lives (count / median [top-2s / post / "
            "update]): " + "; ".join(
                f"{k}: {v['count']} / {v.get('median', 0):.0f} "
                f"[{v.get('reduce', 0):.0f} / {v.get('post', 0):.0f} / "
                f"{v.get('update', 0):.0f}]" for k, v in by_row.items()
                if isinstance(v, dict))
            + f"; bidders of > 32-bidder rounds on staged rows "
              f"{by_row['>32 share staged']:.3f}")
    log(f"  crossover: the warp path is faster up to {measured} bidders "
        f"(measured); the kernel's rule ran rounds of up to "
        f"{chosen['warp_path_up_to']} bidders in one warp and of "
        f"{chosen['cta_path_from']} or more on the CTA path")
    return {"buckets": table, "by_bidders": per_count,
            "crossover_measured": measured, "crossover_rule": chosen,
            "by_row": by_row,
            "cycles_sum": {k: int(r[:, 1].sum()) for k, r in runs.items()}}


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def profile_batches(x, k):
    """The first PROFILE_BATCHES batches of the main path's data, streamed
    as one chunk: device time in the phase kernel, in bid_top2, in every
    other kernel, and the host gaps between them, all from one profiled
    run; the wall time of the same run without the profiler is printed
    beside them."""
    from torch.profiler import ProfilerActivity, profile
    xs = x[:PROFILE_BATCHES * k]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aba_stream(xs, k, 8192, solver="auction_fused", device=x.device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    reset_counts()
    unprofiled_ms = run()
    rounds = counts()["rounds"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    phase_us = sum(_self_device_us(e) for e in kernels
                   if "auction_phase" in e.key)
    bid_us = sum(_self_device_us(e) for e in kernels if "bid_top2" in e.key)
    all_us = sum(_self_device_us(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    for e in sorted(kernels, key=_self_device_us, reverse=True)[:8]:
        log(f"  profile: {_self_device_us(e) / 1e3:9.3f} ms device  "
            f"{e.count:7d} launches  {e.key[:90]}")
    if not all_us:
        log("profile: the profiler recorded no device time; the split is "
            "not measured")
        return None
    split = {"rows": xs.shape[0], "rounds": rounds, "wall_ms": wall_ms,
             "auction_phase_device_ms": phase_us / 1e3,
             "bid_top2_device_ms": bid_us / 1e3,
             "other_device_ms": (all_us - phase_us - bid_us) / 1e3,
             "phase_kernel_share": phase_us / all_us,
             "host_gap_ms": wall_ms - all_us / 1e3,
             "idle_share": 1.0 - all_us / 1e3 / wall_ms,
             "kernel_launches": n_kernels,
             "launches_per_round": n_kernels / rounds,
             "launches_per_lap": n_kernels / (PROFILE_BATCHES - 1),
             "unprofiled_wall_ms": unprofiled_ms}
    log("profile split (one profiled run; wall, device time and gaps all "
        "from it): " + json.dumps(split))
    return split


def user_call(x, k, dev, **kw):
    """One ``anticluster`` call as a user makes it, synchronized:
    (result, seconds, counts read just after, zeroed just before)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = anticluster(x, k=k, device=dev, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, counts()


def timed_call(x, k, dev):
    """One call of the main path (the stream route) by :func:`user_call`,
    checked to launch the route's kernels."""
    res, seconds, used = user_call(x, k, dev, chunk_size="auto")
    check(res.route == "stream", f"route {res.route}, expected stream")
    check(res.solver == "auction_fused", f"solver {res.solver}")
    check(all(used[name] > 0 for name in
              ("bid_top2", "gather_rows", "auction_phase")),
          f"kernels not launched on the main path: {used}")
    return res, seconds, used


def main_path(dev, n: int, card: str) -> dict:
    d, k = PRESETS["diabetes"][1], 256
    if n != PRESETS["diabetes"][0]:
        log(f"main path rows cut from {PRESETS['diabetes'][0]} to {n} "
            f"(--n; d={d} and k={k} kept)")
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)

    # The one-time costs: the process's first call of the path, then the
    # main call, identical, with the counters zeroed just before it.
    first, first_s, first_used = timed_call(x, k, dev)
    log(f"first call n={n}: {first_s:.3f} s, {first_used['rounds']} rounds")
    res, main_s, used = timed_call(x, k, dev)
    check(torch.equal(first.labels, res.labels)
          and first_used["rounds"] == used["rounds"],
          "the second call gave other labels or rounds than the first")
    laps = -(-n // k) - 1  # every batch after the first, each solved cold
    check(used["bid_top2"] == laps and used["auction_phase"] == 4 * laps,
          f"expected {laps} bid_top2 (the span) and {4 * laps} auction_phase "
          f"launches for {laps} LAPs: {used}")
    sizes = res.cluster_sizes.cpu().numpy()
    check(sizes.sum() == n and sizes.min() == n // k
          and sizes.max() == -(-n // k), f"unbalanced sizes {sizes.min()}"
          f"..{sizes.max()}")
    gap = float(res.gap)
    check(np.isfinite(gap) and gap >= 0.0, f"gap {gap}")
    ofv = float(objective_centroid(x, res.labels, k))
    rand = np.random.default_rng(0).permutation(np.arange(n) % k)
    ofv_rand = float(objective_centroid(x, torch.from_numpy(rand).to(dev), k))
    check(ofv > ofv_rand, f"objective {ofv} not above random {ofv_rand}")
    rounds = used["rounds"]
    launched = sum(used[name] for name in _build.launches)
    digest = hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest()
    log(f"main path n={n} d={d} k={k} on {card}: route={res.route} "
        f"solver={res.solver} {main_s:.3f} s (first call {first_s:.3f} s); "
        f"launches bid_top2={used['bid_top2']} "
        f"auction_phase={used['auction_phase']} "
        f"gather_rows={used['gather_rows']} ({launched / rounds:.5f} of the "
        f"port's kernels per round); bidding rounds {rounds} "
        f"({rounds / n:.2f} per row, {main_s / rounds * 1e6:.3f} us per "
        f"round), bids {used['bids']}, rounds with a single bidder "
        f"{used['single_bidder_rounds']} "
        f"({used['single_bidder_rounds'] / rounds:.4f}); sizes {sizes.min()}..{sizes.max()}; "
        f"ofv {ofv:.6e} > random {ofv_rand:.6e}; gap {gap:.6e}; labels "
        f"sha256 {digest[:16]}")
    split = profile_batches(x, k)
    if split:  # every kernel, the port's and PyTorch's, from the profile
        log(f"all kernel launches per round on the main call, from the "
            f"profile's {split['launches_per_lap']:.1f} per LAP: "
            f"{split['launches_per_lap'] * laps / rounds:.4f}")
    window = lap_window(x, k, dev, "auction_fused", "factored", laps,
                        "stream route", chunk_size="auto")
    return {"n": n, "main_s": main_s, "first_s": first_s,
            "main_us_per_round": main_s / rounds * 1e6,
            "port_launches_per_round": launched / rounds,
            "launches": used, "ofv": ofv, "ofv_random": ofv_rand, "gap": gap,
            "labels_sha256": digest, "profile": split, "window": window}


# ---------------------------------------------------------------------------
# phase 6: the default route at full size
# ---------------------------------------------------------------------------

STACK_SHAPE = (4, 16384, 22)  # the stacked route's check: G, M, D


def default_route(dev, n: int, card: str, stream: dict) -> dict:
    """``anticluster(x, k=256)`` with the default spec on phase 3's rows:
    the flat route, the dense ``"auction"`` solver, every LAP (its four
    phases) one ``auction_phase_dense`` launch.  A first call, then the
    main call with the counters zeroed just before it and read just after;
    then a window of WINDOW_LAPS LAPs in the middle of a third call under
    the profiler (launches, copies and waits a LAP: no copy between host
    and card, no wait on the card; the idle share) and a fourth profiled whole
    (the dense kernel's device time over the call); then a stacked
    (G, M, D) input through the same solver."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    first, first_s, first_used = user_call(x, k, dev)
    res, main_s, used = user_call(x, k, dev)
    check(res.route == "flat" and res.solver == "auction",
          f"route {res.route} solver {res.solver}, expected flat / auction")
    laps = -(-n // k) - 1
    check(used["auction_phase_dense"] == laps
          and used["plain_rounds"] == 0 and used["auction_phase"] == 0,
          f"expected {laps} auction_phase_dense launches (one a LAP) and no "
          f"round of the Python loop for {laps} LAPs: {used}")
    check(torch.equal(first.labels, res.labels)
          and first_used["rounds"] == used["rounds"],
          "the second call gave other labels or rounds than the first")
    sizes = res.cluster_sizes.cpu().numpy()
    check(sizes.sum() == n and sizes.min() == n // k
          and sizes.max() == -(-n // k), f"unbalanced sizes {sizes.min()}"
          f"..{sizes.max()}")
    gap = float(res.gap)
    check(np.isfinite(gap) and gap >= 0.0, f"gap {gap}")
    ofv = float(objective_centroid(x, res.labels, k))
    check(ofv > stream["ofv_random"],
          f"objective {ofv} not above random {stream['ofv_random']}")
    rounds = used["rounds"]
    launched = sum(used[name] for name in _build.launches)
    digest = hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest()
    log(f"default route n={n} d={d} k={k} on {card}: route={res.route} "
        f"solver={res.solver} {main_s:.3f} s (first call {first_s:.3f} s); "
        f"launches auction_phase_dense={used['auction_phase_dense']} "
        f"({launched / rounds:.5f} of the port's kernels per round); "
        f"bidding rounds {rounds} ({rounds / n:.2f} per row, "
        f"{main_s / rounds * 1e6:.3f} us per round), plain rounds "
        f"{used['plain_rounds']}, bids {used['bids']}, rounds with a single "
        f"bidder {used['single_bidder_rounds']} "
        f"({used['single_bidder_rounds'] / rounds:.4f}); sizes "
        f"{sizes.min()}..{sizes.max()}; ofv {ofv:.6e} > random "
        f"{stream['ofv_random']:.6e}; gap {gap:.6e}; labels sha256 "
        f"{digest[:16]}")
    log(f"  beside phase 3's stream route (auction_fused): "
        f"{stream['main_s']:.3f} s, {stream['launches']['rounds']} rounds, "
        f"{stream['main_us_per_round']:.3f} us per round, ofv "
        f"{stream['ofv']:.6e}, gap {stream['gap']:.6e}, labels sha256 "
        f"{stream['labels_sha256'][:16]} (another solver: other labels)")
    window = lap_window(x, k, dev, "auction", "solve", laps, "default route")
    whole = call_kernel_ms(x, k, dev, "auction_phase_kernel")
    log(f"  the whole call profiled: auction_phase_dense "
        f"{whole['kernel_ms']:.3f} "
        f"ms of device time in {whole['kernel_launches']} launches "
        f"({whole['kernel_ms'] / laps:.4f} ms a LAP), every kernel and copy "
        f"{whole['device_ms']:.3f} ms, against the main call's "
        f"{main_s * 1e3:.1f} ms wall")
    del x
    xs = torch.from_numpy(make("mixture", int(np.prod(STACK_SHAPE[:2])),
                               STACK_SHAPE[2], seed=2)).view(STACK_SHAPE)
    stacked, stacked_s, stacked_used = user_call(xs.to(dev), k, dev)
    G, M, _ = STACK_SHAPE
    check(stacked.route == "stacked" and stacked.solver == "auction"
          and stacked_used["auction_phase_dense"] == -(-M // k) - 1
          and stacked_used["plain_rounds"] == 0,
          f"stacked route {stacked.route}/{stacked.solver}: {stacked_used}")
    for g in range(G):
        check(balance_ok(stacked.labels[g].cpu(), k),
              f"stacked group {g} unbalanced")
    log(f"stacked route {STACK_SHAPE} k={k}: {stacked_s:.3f} s, "
        f"auction_phase_dense launches {stacked_used['auction_phase_dense']} "
        f"(G={G} a launch), {stacked_used['rounds']} rounds, every group "
        f"balanced")
    return {"n": n, "main_s": main_s, "first_s": first_s,
            "main_us_per_round": main_s / rounds * 1e6,
            "port_launches_per_round": launched / rounds,
            "launches": used, "ofv": ofv, "gap": gap,
            "labels_sha256": digest, "window": window, "call_profile": whole,
            "stacked": {"shape": STACK_SHAPE, "seconds": stacked_s,
                        "launches": stacked_used}}


# the profiler's host-side names of a copy and of a wait on the card
# (torch.cuda.synchronize is cudaDeviceSynchronize, which the window's own
# ends make: not counted), and its device-side names of the copies between
# host and card: a read back (DtoH) or an upload (HtoD), pageable or pinned
HOST_READS = ("cudaMemcpy", "cudaStreamSynchronize", "cudaEventSynchronize")
HOST_COPIES = ("Memcpy DtoH", "Memcpy HtoD")


class LapWindow:
    """Within the block every LAP that solver ``name`` solves (its registry
    entry's ``field``: ``"solve"`` for the dense solve, ``"factored"`` for
    the matrix-free one) is counted, and the profiler records LAPs
    ``first`` .. ``first + count - 1`` only: the card is synchronized just
    before the first and just after the last, and the window's wall time
    is the host clock between the two."""

    def __init__(self, name: str, field: str, first: int, count: int):
        self.name, self.field = name, field
        self.first, self.count = first, count
        self.laps = 0
        self.wall_ms = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.entry = asg._REGISTRY[self.name]
        inner = getattr(self.entry, self.field)

        def counted(*args, **kwargs):
            if self.laps == self.first:
                torch.cuda.synchronize()
                self.prof.start()
                self.t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            self.laps += 1
            if self.laps == self.first + self.count:
                torch.cuda.synchronize()
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.stop()
            return out

        asg._REGISTRY[self.name] = self.entry._replace(
            **{self.field: counted})
        return self

    def __exit__(self, *exc):
        asg._REGISTRY[self.name] = self.entry

    def split(self, kernel: str) -> dict:
        """The window's wall time, the device time of ``kernel`` and of all
        kernels and copies, the idle share, and per LAP the device
        launches, the host's copy and wait calls by name and the device's
        copies by direction.  Fails where the profiler recorded no device
        time or no ``kernel`` launch."""
        check(self.wall_ms is not None, f"the window of LAPs {self.first}.."
              f"{self.first + self.count - 1} was not reached "
              f"({self.laps} LAPs)")
        events = self.prof.key_averages()
        device = [e for e in events if _is_kernel(e)]
        all_us = sum(_self_device_us(e) for e in device)
        kern_us = sum(_self_device_us(e) for e in device if kernel in e.key)
        check(all_us > 0 and kern_us > 0, f"the window of LAPs {self.first}"
              f"..{self.first + self.count - 1}: the profiler recorded no "
              f"device time of {kernel}")
        reads = {e.key: e.count / self.count for e in events
                 if not _is_kernel(e) and e.key.startswith(HOST_READS)}
        copies = {e.key: e.count / self.count for e in device
                  if e.key.startswith("Memcpy")}
        return {"laps": [self.first, self.first + self.count - 1],
                "wall_ms": self.wall_ms, "device_ms": all_us / 1e3,
                "kernel_ms": kern_us / 1e3, "kernel": kernel,
                "idle_share": 1.0 - all_us / 1e3 / self.wall_ms,
                "device_launches_per_lap":
                    sum(e.count for e in device) / self.count,
                "kernel_launches_per_lap":
                    sum(e.count for e in device if kernel in e.key)
                    / self.count,
                "host_reads_per_lap": reads,
                "syncs_per_lap": sum(reads.values()),
                "device_copies_per_lap": copies,
                "host_copies_per_lap": sum(
                    v for key, v in copies.items()
                    if key.startswith(HOST_COPIES))}


def call_kernel_ms(x, k, dev, kernel: str, call=None, names=(),
                   **kw) -> dict:
    """One whole call (``anticluster(x, k=k, **kw)``, or ``call()``) under
    the profiler, device activity only: the device
    time and launches of ``kernel``, of every kernel and copy, and of the
    ten largest by name, summed over the call (the wall time is the
    profiler's, not a measurement).  Summed from the profiler's raw
    events: a call of ~17 000 LAPs records ~850 000 of them, and
    ``key_averages`` first builds an event tree, which takes minutes at
    that count (PERF.md).  ``names``: kernels (name parts) whose device
    time and launches are also returned alone, under ``named``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if call is None:
            anticluster(x, k=k, device=dev, **kw)
        else:
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    ranked = sorted(by_name.items(), key=lambda t: -t[1][0])
    mine = [v for key, v in ranked if kernel in key]
    return {"kernel_ms": sum(ms for ms, _ in mine),
            "kernel_launches": sum(c for _, c in mine),
            "device_ms": sum(ms for ms, _ in by_name.values()),
            "launches": sum(c for _, c in by_name.values()),
            "kernels": {key[:80]: {"ms": ms, "launches": c}
                        for key, (ms, c) in ranked[:10]},
            "named": {n: {"ms": sum(ms for key, (ms, _) in ranked
                                    if n in key),
                          "launches": sum(c for key, (_, c) in ranked
                                          if n in key)} for n in names}}


def lap_window(x, k, dev, solver, field, laps, what, call=None,
               **kw) -> dict:
    """One call (``anticluster(x, k=k, **kw)``, or ``call()``) with a
    window of WINDOW_LAPS LAPs (fewer on a short call)
    in its middle under the profiler (:class:`LapWindow`); logs and returns
    the window's split, and fails if the profiler saw no phase kernel, or
    if a LAP read back from the card, uploaded to it or waited for it: a
    device copy between host and card (``Memcpy DtoH`` / ``HtoD``), a
    synchronous ``cudaMemcpy``, or a stream or event synchronize.  Copies
    from device to device (``Memcpy DtoD``, each a ``cudaMemcpyAsync`` of
    the host) wait for nothing and are logged."""
    count = min(WINDOW_LAPS, laps // 2)
    with LapWindow(solver, field, laps // 2 - count // 2, count) as window:
        if call is None:
            anticluster(x, k=k, device=dev, **kw)
        else:
            call()
    split = window.split("auction_phase_kernel")
    waits = {key: v for key, v in split["host_reads_per_lap"].items()
             if key != "cudaMemcpyAsync"}
    check(not split["host_copies_per_lap"] and not waits,
          f"{what}: a LAP reads back from the card, uploads to it or waits "
          f"for it: {split}")
    log(f"  {what}: LAPs {split['laps'][0]}..{split['laps'][1]} profiled: "
        f"{split['kernel_launches_per_lap']:.2f} phase kernel launches and "
        f"{split['device_launches_per_lap']:.2f} device launches a LAP, "
        f"host copy and wait calls a LAP {split['host_reads_per_lap']}, "
        f"device copies a LAP {split['device_copies_per_lap']} (none "
        f"between host and card), idle share {split['idle_share']:.3f} "
        f"(wall {split['wall_ms']:.2f} ms, device {split['device_ms']:.2f} "
        f"ms, phase kernel {split['kernel_ms']:.2f} ms)")
    return split


def label_digests(dev, n: int) -> dict:
    """``--labels``: the labels' sha256 (first 16 hex digits) of phases 3
    and 6 and of phase 7's calls (a)-(e), each called once as a user calls
    it, nothing else checked; a copy of this script in an older checkout
    of the port gives that commit's digests, so two commits compare in one
    call."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    attrs = attributes(n)
    pad = 1 << (n - 1).bit_length()
    G, M, D = STACK_SHAPE
    xs = torch.from_numpy(make("mixture", G * M, D, seed=2)).view(
        STACK_SHAPE).to(dev)
    cs = np.stack([attributes(M, ATTRIBUTE_SEED + g)["class"]
                   for g in range(G)])
    calls = {
        "3 stream": (x, {"chunk_size": "auto"}),
        "6 flat": (x, {}),
        "7a": (x, {"categories": attrs["class"]}),
        "7b": (x, {"fairness": attrs}),
        "7c": (x, {"categories": attrs["class"], "chunk_size": "auto"}),
        "7d": (torch.cat([x, x.new_zeros((pad - n, d))]),
               {"valid_mask": torch.arange(pad, device=dev) < n}),
        "7e": (xs, {"categories": cs}),
    }
    out = {}
    for name, (xx, kw) in calls.items():
        res = anticluster(xx, k=k, device=dev, **kw)
        out[name] = hashlib.sha256(
            res.labels.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


def profile_routes(dev, n: int, card: str) -> dict:
    """``--profile-routes``: the default and stream calls on the main data,
    each a first call, a main call timed by the host clock, a profiled
    window of WINDOW_LAPS LAPs in the middle of a third call, and a fourth
    call profiled whole for its phase kernel's summed device time; then
    the rounds of the first TIMED_LAPS LAPs of the default route through
    the dense kernel's timed instantiation.  It calls only ``anticluster``,
    the solver registry and the dispatchers, so a copy of this script in
    an older checkout of the port (one with the dense phase kernel) times
    that commit the same way, for comparisons in one call."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    laps = -(-n // k) - 1
    first = laps // 2 - WINDOW_LAPS // 2
    out = {"card": card, "root": ROOT}
    for route, solver, field, kernel, kw in (
            ("flat", "auction", "solve", "auction_phase_kernel", {}),
            ("stream", "auction_fused", "factored", "auction_phase_kernel",
             {"chunk_size": "auto"})):
        _, first_s, _ = user_call(x, k, dev, **kw)
        res, main_s, used = user_call(x, k, dev, **kw)
        with LapWindow(solver, field, first, WINDOW_LAPS) as window:
            anticluster(x, k=k, device=dev, **kw)
        whole = call_kernel_ms(x, k, dev, kernel, **kw)
        digest = hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest()
        out[route] = {"main_s": main_s, "first_s": first_s,
                      "rounds": used["rounds"], "bids": used["bids"],
                      "launches": {name: used[name] for name in
                                   _build.launches if used[name]},
                      "labels_sha256": digest[:16],
                      "window": window.split(kernel), "call": whole}
        log(f"profile-routes {route} on {card}: {json.dumps(out[route])}")
    with PhaseRecorder("auction_phase_dense") as rec:
        anticluster(x[:(TIMED_LAPS + 1) * k], k=k, device=dev)
    out["rounds_timed"] = time_rounds(
        rec.calls, phase_kernel.auction_phase_dense_timed,
        f"the first {TIMED_LAPS} LAPs of the default route")
    return out


# ---------------------------------------------------------------------------
# phase 7: the constrained routes at full size
# ---------------------------------------------------------------------------

def constrained_call(x, k, dev, expect, **kw):
    """One constrained call as a user makes it, three times: the first with
    its dense LAPs counted (and those holding the quota mask), the second
    the main call with the counters zeroed just before it and read just
    after, the third with a window of LAPs in its middle profiled (the
    launches, copies and waits a LAP).  Checks the route and solver, one
    auction_phase_dense launch a LAP, no round of the Python loop, no LAP
    copying between host and card or waiting for the card, and equal
    labels and rounds in both."""
    with MaskedLaps() as lap_count:
        first, first_s, first_used = user_call(x, k, dev, **kw)
    res, main_s, used = user_call(x, k, dev, **kw)
    route, solver, laps = expect
    check(res.route == route and res.solver == solver,
          f"route {res.route} solver {res.solver}, expected {route} / "
          f"{solver}")
    check(used["auction_phase_dense"] == laps and lap_count.laps == laps
          and used["plain_rounds"] == 0 and used["auction_phase"] == 0
          and used["bid_top2"] == 0,
          f"expected {laps} auction_phase_dense launches for {laps} "
          f"LAPs and no other solver kernel: {used}, {lap_count.laps} LAPs")
    window = lap_window(x, k, dev, "auction", "solve", laps,
                        f"{route} {list(kw)}", **kw)
    check(torch.equal(first.labels, res.labels)
          and first_used["rounds"] == used["rounds"],
          "the second call gave other labels or rounds than the first")
    gap = float(res.gap.max())
    check(bool(torch.isfinite(res.gap).all()) and float(res.gap.min()) >= 0,
          f"gap {res.gap}")
    return {"main_s": main_s, "first_s": first_s, "launches": used,
            "masked_laps": lap_count.masked, "laps": laps, "window": window,
            "route": res.route, "solver": res.solver, "gap": gap,
            "labels_sha256": hashlib.sha256(
                res.labels.cpu().numpy().tobytes()).hexdigest()}, res


def quality(x, labels, k, real=None) -> dict:
    """Exact balance of the real rows and their objective against a seeded
    random balanced partition of them (both checked)."""
    if real is not None:
        x, labels = x[real], labels[real]
    n = x.shape[0]
    sizes = np.bincount(labels.cpu().numpy(), minlength=k)
    check(sizes.sum() == n and sizes.min() == n // k
          and sizes.max() == -(-n // k),
          f"unbalanced sizes {sizes.min()}..{sizes.max()}")
    ofv = float(objective_centroid(x, labels, k))
    rand = np.random.default_rng(0).permutation(np.arange(n) % k)
    ofv_rand = float(objective_centroid(x, torch.from_numpy(rand).to(
        x.device), k))
    check(ofv > ofv_rand, f"objective {ofv} not above random {ofv_rand}")
    return {"sizes": (int(sizes.min()), int(sizes.max())), "ofv": ofv,
            "ofv_random": ofv_rand}


def constrained_routes(dev, n: int, card: str, masked_run: dict) -> dict:
    """Phase 7: the Section 4.3 and padding calls on phase 3's rows at full
    width, k = 256, each through :func:`constrained_call`: (a) categories
    (flat), (b) three fairness attributes (flat; the masked LAPs), (c)
    categories with chunk_size="auto" (stream, the solver kept "auction",
    the chunks through gather_rows), (d) the rows padded to the next power
    of two (262 144) with a valid_mask (flat), (e) a stacked (4, 16384, 22) input with (4, 16384)
    categories.  Checks exact balance, constraint (5) for one attribute,
    the objective above random, a finite gap >= 0; logs (b)'s largest
    quota excess per attribute."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    attrs = attributes(n)
    cls = attrs["class"]
    laps = -(-n // k) - 1
    out = {}

    def report(name, run, q, extra=""):
        used = run["launches"]
        log(f"({name}) on {card}: route={run['route']} solver="
            f"{run['solver']} {run['main_s']:.3f} s (first call "
            f"{run['first_s']:.3f} s); auction_phase_dense "
            f"{used['auction_phase_dense']} launches ({run['laps']} LAPs, "
            f"{run['masked_laps']} masked), gather_rows "
            f"{used['gather_rows']}; rounds {used['rounds']}, plain rounds "
            f"{used['plain_rounds']}, bids {used['bids']}, single-bidder "
            f"rounds {used['single_bidder_rounds']}; sizes "
            f"{q['sizes'][0]}..{q['sizes'][1]}; ofv {q['ofv']:.6e} > random "
            f"{q['ofv_random']:.6e}; gap {run['gap']:.6e}{extra}; labels "
            f"sha256 {run['labels_sha256'][:16]}")
        out[name] = {**run, **q}

    run, res = constrained_call(x, k, dev, ("flat", "auction", laps),
                                categories=cls)
    lab = res.labels.cpu().numpy()
    check(stratified(lab, cls, k), "(a): constraint (5) does not hold")
    report("a", run, quality(x, res.labels, k), "; constraint (5) exact")

    run, res = constrained_call(x, k, dev, ("flat", "auction", laps),
                                fairness=attrs)
    lab = res.labels.cpu().numpy()
    excess = {a: quota_excess(lab, codes, k) for a, codes in attrs.items()}
    check(run["labels_sha256"] == masked_run["labels_sha256"]
          and run["masked_laps"] == masked_run["masked_laps"],
          "(b): other labels or masked LAPs than phase 2's run of (b)")
    report("b", run, quality(x, res.labels, k),
           f"; largest quota excess {excess} (best-effort, not checked)")
    out["b"]["quota_excess"] = excess

    run, res = constrained_call(x, k, dev, ("stream", "auction", laps),
                                categories=cls, chunk_size="auto")
    chunks = 1 + -(-laps // (CHUNK_ROWS // k))
    check(run["launches"]["gather_rows"] == chunks,
          f"(c): {run['launches']['gather_rows']} gather_rows launches, "
          f"expected {chunks}")
    check(stratified(res.labels.cpu().numpy(), cls, k),
          "(c): constraint (5) does not hold")
    report("c", run, quality(x, res.labels, k), "; constraint (5) exact")

    pad = 1 << (n - 1).bit_length()  # the next power of two, as a mesh pads
    xp = torch.cat([x, x.new_zeros((pad - n, d))])
    vm = torch.arange(pad, device=dev) < n
    run, res = constrained_call(xp, k, dev,
                                ("flat", "auction", pad // k - 1),
                                valid_mask=vm)
    check(int(res.n_valid) == n and res.balanced,
          f"(d): {res.n_valid} valid rows, balanced {res.balanced}")
    report("d", run, quality(xp, res.labels, k, vm),
           f"; {pad} rows, {n} valid")
    del xp, vm

    G, M, D = STACK_SHAPE
    xs = torch.from_numpy(make("mixture", G * M, D, seed=2)).view(
        STACK_SHAPE).to(dev)
    cs = np.stack([attributes(M, ATTRIBUTE_SEED + g)["class"]
                   for g in range(G)])
    run, res = constrained_call(xs, k, dev, ("stacked", "auction",
                                             -(-M // k) - 1),
                                categories=cs)
    qs = [quality(xs[g], res.labels[g], k) for g in range(G)]
    for g in range(G):
        check(stratified(res.labels[g].cpu().numpy(), cs[g], k),
              f"(e): constraint (5) does not hold in group {g}")
    report("e", run, {"sizes": (min(q["sizes"][0] for q in qs),
                                max(q["sizes"][1] for q in qs)),
                      "ofv": min(q["ofv"] for q in qs),
                      "ofv_random": max(q["ofv_random"] for q in qs)},
           f"; {STACK_SHAPE}, G={G} a launch, constraint (5) exact in "
           f"every group (ofv: the least group's, random: the largest)")
    return out


# ---------------------------------------------------------------------------
# phase 4: the path against its plain kernels
# ---------------------------------------------------------------------------

# Phase 4's rows.  Its Python loops set its time, linearly in the rows:
# at 16 384 rows phase 4 took 313 s of a 1 074 s run of this script on
# an H100, at 8 192 204 s of 1 213 s on a slow host, at 4 096 105 s of
# 1 087 s on a slower one (PERF.md): 2 048 keeps the script well inside
# its limit there.
PLAIN_N = 2048


def against_plain(dev):
    n, d, k, chunk = PLAIN_N, PRESETS["diabetes"][1], 256, PLAIN_N // 2
    x = torch.from_numpy(make("mixture", n, d, seed=1)).to(dev)
    kw = dict(k=k, chunk_size=chunk, solver="auction_fused", device=dev)
    res = anticluster(x, **kw)
    reset_counts()
    with ops.forced_path("ref"):
        plain = anticluster(x, **kw)
        inside = counts()
    check(not any(inside[name] for name in _build.launches),
          f"kernels launched under the forced plain path: {inside}")
    for r in (res, plain):
        check(balance_ok(r.labels.cpu(), k), "unbalanced")
    o_k = float(objective_centroid(x, res.labels, k))
    o_p = float(objective_centroid(x, plain.labels, k))
    check(abs(o_k - o_p) <= 1e-3 * o_p, f"objectives {o_k} vs {o_p}")
    agree = (res.labels == plain.labels).float().mean().item()
    log(f"n={n} k={k} chunk={chunk}: kernels vs plain ofv {o_k:.6e} vs "
        f"{o_p:.6e} (rel {abs(o_k - o_p) / o_p:.2e}); labels agree on "
        f"{agree:.4f} of rows; both balanced")
    return {"agree": agree, "rel": abs(o_k - o_p) / o_p,
            "flat": flat_against_plain(x, k, dev),
            "constrained": constrained_against_plain(x, k, dev),
            "hierarchical": hierarchical_against_plain(x, dev)}


def flat_against_plain(x, k, dev) -> dict:
    """The default spec's flat route on the same rows, through the dense
    phase kernel and with every phase in the Python loop over top2
    (``forced_path("ref")``, the parent's solver): the labels bitwise
    equal; both wall times.  (The gap is not compared: its cluster sums
    use ``index_add_``, which adds in no fixed order on the card.)"""
    res, kernel_s, used = user_call(x, k, dev)
    check(res.route == "flat" and res.solver == "auction"
          and used["auction_phase_dense"] == -(-x.shape[0] // k) - 1
          and used["plain_rounds"] == 0,
          f"flat route {res.route}/{res.solver} launches {used}")
    with ops.forced_path("ref"):
        plain, plain_s, inside = user_call(x, k, dev)
    check(not any(inside[name] for name in _build.launches)
          and inside["plain_rounds"] > 0,
          f"kernels launched under the forced plain path: {inside}")
    check(torch.equal(res.labels, plain.labels),
          "the flat route's labels differ from the forced plain path's")
    log(f"flat route n={x.shape[0]} k={k} (default spec): labels bitwise "
        f"equal to the forced plain path's; dense kernel {kernel_s:.3f} s "
        f"({used['rounds']} rounds), Python loop over top2 {plain_s:.3f} s "
        f"({inside['rounds']} rounds, predicate every {ref._CHECK_EVERY})")
    return {"kernel_s": kernel_s, "plain_s": plain_s,
            "rounds": used["rounds"], "plain_rounds": inside["rounds"]}


def constrained_against_plain(x, k, dev) -> dict:
    """Phase 7's calls (a), (b) and (d) at phase 4's n through the dense
    phase kernel and with every phase in the Python loop over top2
    (``forced_path("ref")``): labels bitwise equal, both times.  (d) keeps
    the share of real rows of the full call (253 680 of 262 144) and zeroes
    the rest.  Then the categorical stream core with ``chunk_size >= n``
    against the flat core: labels bitwise equal."""
    n = x.shape[0]
    attrs = attributes(n)
    real = n * PRESETS["diabetes"][0] // (1 << (PRESETS["diabetes"][0]
                                                 - 1).bit_length())
    xp = torch.cat([x[:real], x.new_zeros((n - real, x.shape[1]))])
    calls = {"a": (x, {"categories": attrs["class"]}),
             "b": (x, {"fairness": attrs}),
             "d": (xp, {"valid_mask": torch.arange(n, device=dev) < real})}
    out = {}
    for name, (xx, kw) in calls.items():
        res, kernel_s, used = user_call(xx, k, dev, **kw)
        check(res.route == "flat" and res.solver == "auction"
              and used["auction_phase_dense"] == -(-n // k) - 1
              and used["plain_rounds"] == 0,
              f"({name}) route {res.route}/{res.solver} launches {used}")
        with ops.forced_path("ref"):
            plain, plain_s, inside = user_call(xx, k, dev, **kw)
        check(not any(inside[kn] for kn in _build.launches)
              and inside["plain_rounds"] > 0,
              f"({name}): kernels launched under the forced plain path: "
              f"{inside}")
        check(torch.equal(res.labels, plain.labels),
              f"({name}): labels differ from the forced plain path's")
        log(f"({name}) n={n} k={k} {list(kw)}: labels bitwise equal to the "
            f"forced plain path's; dense kernel {kernel_s:.3f} s "
            f"({used['rounds']} rounds), Python loop over top2 "
            f"{plain_s:.3f} s ({inside['rounds']} rounds)")
        out[name] = {"kernel_s": kernel_s, "plain_s": plain_s,
                     "rounds": used["rounds"],
                     "plain_rounds": inside["rounds"]}
    cls = torch.from_numpy(attrs["class"]).to(dev)
    flat = aba_core(x[None], k, categories=cls[None], n_categories=3,
                    device=dev)[0]
    reset_counts()
    stream = aba_stream(x, k, n, categories=cls, n_categories=3, device=dev)
    used = counts()
    check(used["gather_rows"] > 0 and used["auction_phase_dense"] > 0,
          f"the categorical stream core launched {used}")
    check(torch.equal(stream, flat),
          "the categorical stream core (chunk_size >= n) differs from the "
          "flat core")
    log(f"categorical stream core n={n} k={k} chunk_size=n: labels bitwise "
        f"equal to the flat core's ({used['gather_rows']} gather_rows, "
        f"{used['auction_phase_dense']} auction_phase_dense launches)")
    out["stream_equals_flat"] = True
    return out


# ---------------------------------------------------------------------------
# the hierarchical route: phase 8, and its parts of phases 2 and 4
# ---------------------------------------------------------------------------

# The Table-10 regime of benchmarks/table10_scale.py: n = 2^20 rows of
# d = 32 low-rank features, 128 MB on the card, nothing cut.
HIER_N, HIER_D = 1 << 20, 32
HIER_K = 4096          # plan (64, 64): benchmarks/table10_scale.py
HIER_K_LARGE = 131072  # plan (256, 512): its largest k
HIER_PHASE_BUDGET_S = 120.0  # past this, call (c) runs once (PERF.md §4)


@functools.lru_cache(maxsize=1)
def hier_rows(dev) -> torch.Tensor:
    return torch.from_numpy(make("lowrank", HIER_N, HIER_D, seed=0)).to(dev)


def first_by_groups(field: str, limits: dict):
    """A PhaseRecorder ``keep``: the first ``limits[G]`` calls whose
    argument ``field`` is a stack of G groups."""
    seen = {}

    def keep(kw):
        G = kw[field].shape[0]
        seen[G] = seen.get(G, 0) + 1
        return seen[G] <= limits.get(G, 0)
    return keep


def timed_loop(calls, what, loop, kernel):
    """:func:`check_phase_calls`, logged with its wall time."""
    t0 = time.perf_counter()
    checked = check_phase_calls(calls, what, loop, kernel)
    seconds = time.perf_counter() - t0
    log(f"{kernel}: {checked} launches of {what} bitwise equal to the "
        f"every-round Python loop ({seconds:.1f} s), with equal rounds, bids "
        f"and single-bidder rounds: {[c['rounds'] for c in calls]} rounds")
    return seconds


def check_hierarchical_phases(dev) -> dict:
    """Phase 2 at the hierarchical route's shapes, on phase 8's rows: the
    dense kernel on the G = 64, n = 64 stack of call (a)'s first level-2 LAP
    and on call (c)'s first level-2 batch (G = 256, n = 512, 268 MB of
    cost), the factored kernel on the four phases of call (b)'s first
    G = 64 LAP, each bitwise against the every-round Python loop; the
    span's pair on (b)'s first LAP at G = 1 and at G = 64 against the plain
    pair (:func:`check_span`); then the
    dense kernel's rounds timed by bidders on the first 16 LAPs of (a)'s
    level 1 (n = 64) and on 16 G = 1 LAPs at n = 512 (the first 16 groups
    of (c)'s batch, each solved alone: its assignment and prices equal to
    its group's in the stack)."""
    x = hier_rows(dev)
    dense = "auction_phase_dense"
    with PhaseRecorder(dense, first_by_groups("cost", {1: TIMED_LAPS, 64: 1})
                       ) as rec_a:
        anticluster(x, k=HIER_K, device=dev)
    with PhaseRecorder("auction_phase", first_by_groups("x", {1: 4, 64: 4})
                       ) as rec_b:
        anticluster(x, k=HIER_K, device=dev, chunk_size="auto")
    with PhaseRecorder(dense, first_by_groups("cost", {256: 1})) as rec_c:
        anticluster(x, k=HIER_K_LARGE, device=dev)
    small = [c for c in rec_a.calls if c["kw"]["cost"].shape[0] == 1]
    stack_a = [c for c in rec_a.calls if c["kw"]["cost"].shape[0] == 64]
    small_b = [c for c in rec_b.calls if c["kw"]["x"].shape[0] == 1]
    stack_b = [c for c in rec_b.calls if c["kw"]["x"].shape[0] == 64]
    check(len(small) == TIMED_LAPS and len(stack_a) == 1
          and len(small_b) == 4 and len(stack_b) == 4
          and len(rec_c.calls) == 1,
          f"recorded {len(small)}, {len(stack_a)}, {len(small_b)}, "
          f"{len(stack_b)}, {len(rec_c.calls)} launches")
    span_err = check_span([small_b[0]["kw"], stack_b[0]["kw"]],
                          "(b)'s first LAP at G=1 and at G=64")
    loop = ref.auction_phase_dense_ref
    out = {"a_level2_s": timed_loop(stack_a, "(a)'s first level-2 LAP "
                                    "(G=64 n=64)", loop, dense),
           "b_level2_s": timed_loop(stack_b, "(b)'s first level-2 LAP "
                                    "(G=64 n=64, 4 phases)",
                                    loop_over_bid_top2, "auction_phase"),
           "b_span_max_abs_err": span_err,
           "c_level2_s": timed_loop(rec_c.calls, "(c)'s first level-2 batch "
                                    "(G=256 n=512)", loop, dense)}
    stack = rec_c.calls[0]
    singles = []
    for g in range(TIMED_LAPS):
        with PhaseRecorder(dense) as rec:
            asg.auction_solve(stack["kw"]["cost"][g:g + 1], device=dev)
        call = rec.calls[0]
        check(torch.equal(call["out"][0][0], stack["out"][0][g])
              and torch.equal(call["out"][1][0], stack["out"][1][g]),
              f"group {g} of (c)'s level-2 batch solved alone differs from "
              f"the stack")
        singles.append(call)
    timed = phase_kernel.auction_phase_dense_timed
    out["rounds_timed"] = {
        "n64": time_rounds(small, timed, f"the first {TIMED_LAPS} LAPs of "
                           f"(a)'s level 1, n=64"),
        "n512": time_rounds(singles, timed, f"{TIMED_LAPS} LAPs at n=512, "
                            f"groups 0-{TIMED_LAPS - 1} of (c)'s first "
                            f"level-2 batch, each solved alone")}
    return out


def hierarchical_against_plain(x, dev) -> dict:
    """Phase 4 on the hierarchical route: ``plan=(8, 16)`` on phase 4's
    rows, dense and with ``chunk_size=PLAIN_N // 2`` (level 1 streamed in
    two chunks), through the kernels and with every phase in the Python loop
    (``forced_path("ref")``): labels bitwise equal.  Then ``batched=False``
    (a G = 1 solve a group) against the stacked levels: labels equal, or
    the first level-2 LAP that differs and what differs in it (the group's
    centroid, the stacked cost product, the kernel's output) logged, and
    either way both balanced with objectives within 1e-3 relative."""
    plan, k = (8, 16), 128
    out = {}
    chunk = PLAIN_N // 2
    for name, xx, kw in (("dense", x, {}), (f"chunk {chunk}", x,
                                            {"chunk_size": chunk})):
        n = xx.shape[0]
        laps1, laps2 = n // plan[0] - 1, n // plan[0] // plan[1] - 1
        res, kernel_s, used = user_call(xx, k, dev, plan=plan, **kw)
        check(res.route == "hier" and res.plan == plan
              and res.solver == "auction"
              and used["auction_phase_dense"] == laps1 + laps2
              and used["plain_rounds"] == 0
              and (used["gather_rows"] > 0) == ("chunk_size" in kw),
              f"hier {name}: {res.route} {res.plan} {res.solver} {used}")
        with ops.forced_path("ref"):
            plain, plain_s, inside = user_call(xx, k, dev, plan=plan, **kw)
        check(not any(inside[kn] for kn in _build.launches)
              and inside["plain_rounds"] > 0,
              f"hier {name}: kernels launched under the forced plain path: "
              f"{inside}")
        check(torch.equal(res.labels, plain.labels),
              f"hier {name}: labels differ from the forced plain path's")
        log(f"hierarchical route n={n} plan={plan} {name}: labels bitwise "
            f"equal to the forced plain path's; kernels {kernel_s:.3f} s "
            f"({used['rounds']} rounds, {used['auction_phase_dense']} dense "
            f"launches: {laps1} at G=1, {laps2} at G={plan[0]}), Python loop "
            f"{plain_s:.3f} s ({inside['rounds']} rounds)")
        out[name] = {"kernel_s": kernel_s, "plain_s": plain_s,
                     "rounds": used["rounds"],
                     "plain_rounds": inside["rounds"]}
    n = x.shape[0]
    laps1, laps2 = n // plan[0] - 1, n // plan[0] // plan[1] - 1
    dense = "auction_phase_dense"
    count = iter(range(1 << 30))
    with PhaseRecorder(dense, first_by_groups("cost", {plan[0]: laps2})
                       ) as stacked:
        one = anticluster(x, k=k, device=dev, plan=plan, stats=False)
    with PhaseRecorder(dense, lambda kw: next(count) >= laps1) as alone:
        per_group = anticluster(x, k=k, device=dev, plan=plan, stats=False,
                                batched=False)
    equal = torch.equal(one.labels, per_group.labels)
    first = None
    for g in range(plan[0]):
        for b in range(laps2):
            s, a = stacked.calls[b], alone.calls[g * laps2 + b]
            same_cost = torch.equal(s["kw"]["cost"][g], a["kw"]["cost"][0])
            same_out = (torch.equal(s["out"][0][g], a["out"][0][0])
                        and torch.equal(s["out"][1][g], a["out"][1][0]))
            if first is None and not (same_cost and same_out):
                first = {"group": g, "batch": b, "cost_equal": same_cost,
                         "kernel_out_equal": same_out}
    check(equal == (first is None),
          f"batched=False: labels equal {equal}, first differing LAP {first}")
    o_one = float(objective_centroid(x, one.labels, k))
    o_alone = float(objective_centroid(x, per_group.labels, k))
    check(balance_ok(one.labels.cpu(), k)
          and balance_ok(per_group.labels.cpu(), k)
          and abs(o_one - o_alone) <= 1e-3 * o_one,
          f"batched=False: objectives {o_alone} vs {o_one}, or unbalanced")
    # the two candidate causes, on the level-2 stack of the shared level 1
    glabels = torch.div(one.labels.long(), plan[1], rounding_mode="floor")
    idx, valid = _regroup(glabels, torch.ones_like(glabels, dtype=torch.bool),
                          plan[0], -(-n // plan[0]))
    xg = torch.cat([x, x.new_zeros((1, x.shape[1]))])[idx]
    mu, _ = _centrality(xg, valid)
    mu_equal = all(torch.equal(_centrality(xg[g:g + 1], valid[g:g + 1])[0][0],
                               mu[g]) for g in range(plan[0]))
    cents = xg[:, :plan[1]]
    prod = torch.einsum("gid,gjd->gij", xg[:, plan[1]:2 * plan[1]], cents)
    # (the stack's first rows stand in for a batch and the centroids)
    einsum_equal = all(torch.equal(torch.einsum(
        "gid,gjd->gij", xg[g:g + 1, plan[1]:2 * plan[1]], cents[g:g + 1])[0],
        prod[g]) for g in range(plan[0]))
    log(f"hierarchical route n={n} plan={plan}: batched=False labels "
        f"{'equal to' if equal else 'differ from'} batched=True's; first "
        f"level-2 LAP that differs: {first}; on the level-2 stack, each "
        f"group's centroid alone equals the stacked one: {mu_equal}, the "
        f"stacked cost product equals each group's: {einsum_equal}; both "
        f"balanced, objectives {o_alone:.6e} and {o_one:.6e}")
    out["batched_false"] = {"labels_equal": equal, "first_diff": first,
                            "ofv": o_one, "ofv_unbatched": o_alone,
                            "centroid_equal": mu_equal,
                            "einsum_equal": einsum_equal}
    return out


class LevelLaps:
    """Within the block every LAP of the solvers ``"auction"`` and
    ``"auction_fused"`` (their dense ``solve`` and matrix-free
    ``factored`` entries) is counted by its stack's G, and so are the
    port's kernel launches it made (``_build.launches``, read on the host:
    no sync)."""

    def __enter__(self):
        self.saved = {name: asg._REGISTRY[name]
                      for name in ("auction", "auction_fused")}
        self.laps, self.launches = {}, {}

        def counted(inner):
            def run(first, *args, **kwargs):
                before = dict(_build.launches)
                out = inner(first, *args, **kwargs)
                G = first.shape[0]
                self.laps[G] = self.laps.get(G, 0) + 1
                per = self.launches.setdefault(G, {})
                for name, v in _build.launches.items():
                    if v != before[name]:
                        per[name] = per.get(name, 0) + v - before[name]
                return out
            return run

        for name, entry in self.saved.items():
            asg._REGISTRY[name] = entry._replace(
                solve=counted(entry.solve),
                factored=entry.factored and counted(entry.factored))
        return self

    def __exit__(self, *exc):
        asg._REGISTRY.update(self.saved)

    def per_lap(self) -> dict:
        """G -> {"laps": count, kernel: launches a LAP}."""
        return {G: {"laps": laps, **{name: v / laps for name, v in
                                     self.launches.get(G, {}).items()}}
                for G, laps in sorted(self.laps.items())}


def hier_call(x, k, dev, expect, windows=False, once=False, **kw):
    """One call of phase 8 as a user makes it, as ``(run, result)``: a
    first call with its LAPs counted by level (:class:`LevelLaps`), then
    the main call with the counters zeroed just before it and read just
    after; checks the route, plan and solver, the LAPs of each level and
    the kernels' launches a LAP, equal labels and rounds in both, exact
    balance, the objective above a seeded random partition and a finite
    gap >= 0.  With ``once`` the first call is the main call.  With
    ``windows`` the first call profiles WINDOW_LAPS LAPs in the middle of
    level 1 and of level 2 (device launches a LAP at G = 1 and at G =
    plan[0]: no copy between host and card, no wait; its time includes
    the two windows' synchronizes and profiler)."""
    route, plan, solver = expect
    n = x.shape[0]
    laps, m = {}, n
    for li, k_l in enumerate(plan):
        groups = math.prod(plan[:li])
        laps[groups] = -(-m // k_l) - 1
        m = -(-m // k_l)
    field = "factored" if solver == "auction_fused" else "solve"
    l1, half = laps[1], WINDOW_LAPS // 2
    with contextlib.ExitStack() as stack:
        levels = stack.enter_context(LevelLaps())
        if windows:
            w1, w2 = (stack.enter_context(LapWindow(
                solver, field, at, WINDOW_LAPS)) for at in (
                    l1 // 2 - half, l1 + laps[plan[0]] // 2 - half))
        first, first_s, first_used = user_call(x, k, dev, **kw)
    res, main_s, used = ((first, first_s, first_used) if once
                         else user_call(x, k, dev, **kw))
    check(res.route == route and res.plan == plan and res.solver == solver,
          f"route {res.route} plan {res.plan} solver {res.solver}, expected "
          f"{expect}")
    per_lap = levels.per_lap()
    want_launches = ({"bid_top2": 1.0, "auction_phase": 4.0}
                     if solver == "auction_fused"
                     else {"auction_phase_dense": 1.0})
    for G, want in laps.items():
        got = per_lap.get(G, {})
        check(got.get("laps") == want and all(
            got.get(name) == v for name, v in want_launches.items()),
            f"level with G={G}: {got}, expected {want} LAPs and "
            f"{want_launches} a LAP")
    check(used["plain_rounds"] == 0 and torch.equal(first.labels, res.labels)
          and first_used["rounds"] == used["rounds"],
          f"plain rounds {used['plain_rounds']}, or the second call gave "
          f"other labels or rounds than the first")
    q = quality(x, res.labels, k)
    gap = float(res.gap)
    check(np.isfinite(gap) and gap >= 0.0, f"gap {gap}")
    digest = hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest()
    run = {"route": res.route, "plan": list(res.plan), "solver": res.solver,
           "main_s": main_s, "first_s": first_s,
           "launches": {name: used[name] for name in _build.launches
                        if used[name]},
           "rounds": used["rounds"], "bids": used["bids"],
           "single_bidder_rounds": used["single_bidder_rounds"],
           "per_level": per_lap, "gap": gap, **q, "once": once,
           "labels_sha256": digest}
    if windows:
        run["windows"] = {}
        for G, w in ((1, w1), (plan[0], w2)):
            split = w.split("auction_phase_kernel")
            waits = {key: v for key, v in split["host_reads_per_lap"].items()
                     if key != "cudaMemcpyAsync"}
            check(not split["host_copies_per_lap"] and not waits,
                  f"G={G}: a LAP reads back from the card, uploads to it or "
                  f"waits for it: {split}")
            run["windows"][G] = split
    return run, res


def hierarchical_routes(dev, card: str) -> dict:
    """Phase 8: the hierarchical route on the Table-10 rows (n = 2^20, d =
    32, low rank) through ``anticluster`` as a user calls it, each call by
    :func:`hier_call`: (a) k = 4096 with the default spec (plan (64, 64),
    the dense solver), (b) the same with ``chunk_size="auto"`` (level 1
    streamed in 8192-row chunks, ``"auction_fused"``), (c) k = 131072
    (plan (256, 512)), (d) (a) with ``categories=`` the class codes of
    ATTRIBUTE_COUNTS (constraint (5) exact); (a), (b) and (d) one call
    each, (a) and (b) with their levels' LAPs profiled.  Then (e)
    ``kplus_moments=2``
    on phase 3's rows at k = 256 (the flat route, d = 22 -> 44): the
    moment-2 spread below that of the same call without k-plus."""
    x = hier_rows(dev)
    cls = attributes(HIER_N)["class"]
    t0 = time.perf_counter()
    out = {}

    def report(name, run, extra=""):
        per = "; ".join(
            f"G={G}: {v['laps']} LAPs, " + ", ".join(
                f"{kn} {c:g}" for kn, c in v.items() if kn != "laps")
            + " a LAP" for G, v in run["per_level"].items())
        other = ("one call" if run["once"]
                 else f"first call {run['first_s']:.3f} s")
        log(f"({name}) on {card}: route={run['route']} plan={run['plan']} "
            f"solver={run['solver']} {run['main_s']:.3f} s ({other}); "
            f"launches {run['launches']} ({per}); "
            f"rounds {run['rounds']}, bids {run['bids']}, single-bidder "
            f"rounds {run['single_bidder_rounds']}; sizes "
            f"{run['sizes'][0]}..{run['sizes'][1]}; ofv {run['ofv']:.6e} > "
            f"random {run['ofv_random']:.6e}; gap {run['gap']:.6e}{extra}; "
            f"labels sha256 {run['labels_sha256'][:16]}")
        for G, split in run.get("windows", {}).items():
            log(f"  ({name}) LAPs {split['laps'][0]}..{split['laps'][1]} "
                f"(G={G}) profiled: {split['device_launches_per_lap']:.2f} "
                f"device launches and {split['kernel_launches_per_lap']:.2f} "
                f"phase kernel launches a LAP, host copy and wait calls a LAP "
                f"{split['host_reads_per_lap']}, device copies a LAP "
                f"{split['device_copies_per_lap']}, idle share "
                f"{split['idle_share']:.3f} (wall {split['wall_ms']:.2f} ms, "
                f"device {split['device_ms']:.2f} ms)")
        out[name] = run

    report("a", hier_call(x, HIER_K, dev, ("hier", (64, 64), "auction"),
                          windows=True, once=True)[0])
    report("b", hier_call(x, HIER_K, dev, ("hier", (64, 64), "auction_fused"),
                          windows=True, once=True, chunk_size="auto")[0])
    chunks = 1 + -(-(HIER_N // 64 - 1) // (CHUNK_ROWS // 64))
    check(out["b"]["launches"]["gather_rows"] == chunks,
          f"(b): {out['b']['launches']['gather_rows']} gather_rows launches, "
          f"expected {chunks}")
    # one call: labels and rounds are held equal to a second call's by (c)
    # where the phase has time, and by phases 3, 4 and 6
    run, res = hier_call(x, HIER_K, dev, ("hier", (64, 64), "auction"),
                         once=True, categories=cls)
    check(stratified(res.labels.cpu().numpy(), cls, HIER_K),
          "(d): constraint (5) does not hold")
    report("d", run, "; constraint (5) exact")
    spent = time.perf_counter() - t0
    once = spent > HIER_PHASE_BUDGET_S  # then the first call is the main
    report("c", hier_call(x, HIER_K_LARGE, dev, ("hier", (256, 512),
                                                 "auction"), once=once)[0],
           f"; run once (phase 8 had taken {spent:.1f} s)" if once else "")

    d, k = PRESETS["diabetes"][1], 256
    xd = torch.from_numpy(make("mixture", PRESETS["diabetes"][0], d,
                               seed=0)).to(dev)
    first, first_s, _ = user_call(xd, k, dev, kplus_moments=2)
    res, main_s, used = user_call(xd, k, dev, kplus_moments=2)
    check(res.route == "flat" and res.solver == "auction"
          and used["auction_phase_dense"] == -(-xd.shape[0] // k) - 1
          and torch.equal(first.labels, res.labels),
          f"(e): {res.route} {res.solver} {used}")
    xa = kplus_augment(xd, 2)
    check(xa.shape[1] == 2 * d, f"(e): {xa.shape[1]} features")
    q = quality(xa, res.labels, k)
    gap = float(res.gap)
    check(np.isfinite(gap) and gap >= 0.0, f"(e): gap {gap}")
    spread = moment_spread(xd, res.labels, k, 2)
    plain_spread = moment_spread(
        xd, anticluster(xd, k=k, device=dev).labels, k, 2)
    check(spread < plain_spread,
          f"(e): moment-2 spread {spread} not below {plain_spread}")
    digest = hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest()
    log(f"(e) kplus_moments=2 on {card}: route={res.route} d={d}->{2 * d} "
        f"{main_s:.3f} s (first call {first_s:.3f} s); auction_phase_dense "
        f"{used['auction_phase_dense']}; sizes {q['sizes']}; ofv (augmented) "
        f"{q['ofv']:.6e} > random {q['ofv_random']:.6e}; gap {gap:.6e}; "
        f"moment-2 spread {spread:.6e} against {plain_spread:.6e} without "
        f"k-plus; labels sha256 {digest[:16]}")
    out["e"] = {"main_s": main_s, "first_s": first_s, "gap": gap, **q,
                "launches": {"auction_phase_dense":
                             used["auction_phase_dense"]},
                "moment_spread": spread, "moment_spread_plain": plain_spread,
                "labels_sha256": digest}
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 9: sessions at full size
# ---------------------------------------------------------------------------

SESSION_EPOCHS = 3      # warm repartitions of each session
DELTA_SHARE = 0.01      # the update's delta: rows removed, as many added
DELTA_SEED = 9          # which rows leave
DEFAULT_DIGEST = "65b9e33e025c4278"  # the default route's labels, runs 61-87
PLAIN_SESSION_N = 4096  # (e): warm solves and updates against the plain path
#                          (16 384 until phase 16 came: 89 s of loops; 8 192
#                          until the script took 1 087 s on a slow host)
HOST_WORK = (24, 1024)   # (d): float64 matmuls of this order, the host work


class SkipCounter:
    """Within the block the phases that each LAP sits out (the ``skip``
    the warm schedule hands the phase kernels) are summed on the card, by
    phase: no read to the host in a LAP, one small reduction a LAP.
    ``laps`` counts the dense launches, ``phases`` the factored ones."""

    def __init__(self, n_phases: int = 4):
        self.n_phases = n_phases
        self.dense = self.factored = None
        self.laps = self.phases = 0

    def __enter__(self):
        self.inner = (ops.auction_phase_dense, ops.auction_phase)
        dense_fn, factored_fn = self.inner

        def dense(cost, prices, eps, *args, skip=None, **kw):
            self.laps += 1
            if skip is not None:
                s = skip.sum(dim=1)
                self.dense = s if self.dense is None else self.dense + s
            return dense_fn(cost, prices, eps, *args, skip=skip, **kw)

        def factored(x, c, is_real, prices, eps, *args, skip=None, **kw):
            p = self.phases % self.n_phases
            self.phases += 1
            if skip is not None:
                if self.factored is None:
                    self.factored = torch.zeros(self.n_phases,
                                                dtype=torch.int64,
                                                device=x.device)
                self.factored[p] += skip.sum()
            return factored_fn(x, c, is_real, prices, eps, *args, skip=skip,
                               **kw)

        ops.auction_phase_dense, ops.auction_phase = dense, factored
        return self

    def __exit__(self, *exc):
        ops.auction_phase_dense, ops.auction_phase = self.inner

    def skipped(self) -> list:
        """Instances that sat out each phase, summed over the LAPs."""
        t = self.dense if self.dense is not None else self.factored
        return [0] * self.n_phases if t is None else t.tolist()


def session_call(fn, *args, **kw):
    """``fn(*args, **kw)`` synchronized: (its output, seconds, counts read
    just after, zeroed just before)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, counts()


def balanced(labels, k: int) -> tuple[int, int]:
    """The sizes' (min, max), checked to be exact balance."""
    sizes = torch.bincount(labels.long(), minlength=k).cpu().numpy()
    n = int(sizes.sum())
    check(sizes.min() == n // k and sizes.max() == -(-n // k),
          f"unbalanced sizes {sizes.min()}..{sizes.max()}")
    return int(sizes.min()), int(sizes.max())


def digest_of(labels) -> str:
    return hashlib.sha256(labels.cpu().numpy().tobytes()).hexdigest()[:16]


def warm_session(x, k, dev, card, name, expect, kernel, solver, field,
                 **kw):
    """One engine's cold ``partition`` and SESSION_EPOCHS warm
    ``repartition`` calls on the same rows, each timed with its counters
    and its skipped phases; the warm objective within 1 % of the cold
    one, balance exact; then a window of LAPs of one more warm call
    profiled (no host read or wait in a LAP).  Returns (the run, the
    engine, the states: the partition's and each epoch's)."""
    eng = AnticlusterEngine(k=k, device=dev, **kw)
    n = x.shape[0]
    laps = -(-n // k) - 1
    (res, state), cold_s, cold_used = session_call(eng.partition, x)
    check((res.route, res.solver) == expect,
          f"({name}) route {res.route}/{res.solver}, expected {expect}")
    check(cold_used[kernel] > 0 and cold_used["plain_rounds"] == 0,
          f"({name}) partition launches {cold_used}")
    balanced(res.labels, k)
    ofv_cold = float(objective_centroid(x, res.labels, k))
    run = {"route": res.route, "solver": res.solver, "cold_s": cold_s,
           "cold_rounds": cold_used["rounds"], "ofv_cold": ofv_cold,
           "cold_sha256": digest_of(res.labels), "epochs": [],
           "launches": {"partition": cold_used}}
    log(f"({name}) partition on {card}: route={res.route} "
        f"solver={res.solver} {cold_s:.3f} s, {cold_used['rounds']} rounds "
        f"({cold_used['rounds'] / n:.2f} per row), {kernel} "
        f"{cold_used[kernel]}, ofv {ofv_cold:.6e}, labels sha256 "
        f"{run['cold_sha256']}")
    states, results = [state], [res]
    for e in range(SESSION_EPOCHS):
        with SkipCounter() as skips:
            (res, state), warm_s, used = session_call(eng.repartition, x,
                                                      state)
        check(used[kernel] > 0 and used["plain_rounds"] == 0,
              f"({name}) warm launches {used}")
        sizes = balanced(res.labels, k)
        ofv = float(objective_centroid(x, res.labels, k))
        check(abs(ofv - ofv_cold) <= 0.01 * ofv_cold,
              f"({name}) warm objective {ofv} not within 1 % of the cold "
              f"{ofv_cold}")
        skipped = skips.skipped()
        epoch = {"seconds": warm_s, "rounds": used["rounds"],
                 "rounds_per_row": used["rounds"] / n,
                 "launches": {key: used[key] for key in _build.launches},
                 "skipped_by_phase": skipped,
                 "skipped_per_lap": sum(skipped) / laps, "sizes": sizes,
                 "ofv": ofv, "ofv_rel_cold": (ofv - ofv_cold) / ofv_cold,
                 "gap": float(res.gap), "sha256": digest_of(res.labels)}
        run["epochs"].append(epoch)
        states.append(state)
        results.append(res)
        log(f"  ({name}) warm repartition {e + 1}: {warm_s:.3f} s, "
            f"{used['rounds']} rounds ({epoch['rounds_per_row']:.3f} per "
            f"row), {kernel} {used[kernel]}, bid_top2 {used['bid_top2']}, "
            f"phases sat out by phase {skipped} "
            f"({epoch['skipped_per_lap']:.3f} a LAP), sizes "
            f"{sizes[0]}..{sizes[1]}, ofv {ofv:.6e} "
            f"({epoch['ofv_rel_cold']:+.2e} against the cold call), gap "
            f"{epoch['gap']:.6e}")
    check(eng.compile_count == 1,
          f"({name}) {eng.compile_count} solve closures for one shape")
    run["window"] = lap_window(
        x, k, dev, solver, field, laps, f"({name}) a warm repartition",
        call=lambda: eng.repartition(x, states[-1]))
    return run, eng, states, results


def session_against_plain(x, dev, kw) -> dict:
    """(e): a warm repartition of drifted rows and an update of that
    session (1 % of the rows out, as many in) through the kernels and with
    every phase in the Python loop (``forced_path("ref")``), from one
    partition's state: labels bitwise equal, both times."""
    n = x.shape[0]
    eng = AnticlusterEngine(device=dev, **kw)
    _, state = eng.partition(x)
    x2 = x + 0.05 * torch.sin(x)
    m = round(n * DELTA_SHARE)
    rng = np.random.default_rng(DELTA_SEED)
    added = torch.from_numpy(make("mixture", m, x.shape[1], seed=2)).to(dev)
    removed = np.sort(rng.choice(n, m, replace=False))

    def run():
        warm, st = eng.repartition(x2, state)
        upd, _, _ = eng.update(x2, st, added=added, removed=removed)
        return warm, upd

    (warm, upd), kernel_s, used = session_call(run)
    check(upd.updated and used["plain_rounds"] == 0
          and used["auction_phase_dense"] > 0, f"(e) {kw}: {used}")
    with ops.forced_path("ref"):
        (pwarm, pupd), plain_s, inside = session_call(run)
    check(not any(inside[name] for name in _build.launches)
          and inside["plain_rounds"] > 0,
          f"(e) {kw}: kernels launched under the forced plain path: "
          f"{inside}")
    check(torch.equal(warm.labels, pwarm.labels),
          f"(e) {kw}: the warm labels differ from the forced plain path's")
    check(torch.equal(upd.labels, pupd.labels),
          f"(e) {kw}: the update's labels differ from the forced plain "
          f"path's")
    log(f"(e) n={n} {kw}: a warm repartition and an update of {m} rows "
        f"out, {m} in: labels bitwise the forced plain path's; kernels "
        f"{kernel_s:.3f} s ({used['rounds']} rounds, auction_phase_dense "
        f"{used['auction_phase_dense']}), Python loop {plain_s:.3f} s "
        f"({inside['rounds']} rounds)")
    return {"kernel_s": kernel_s, "plain_s": plain_s,
            "rounds": used["rounds"], "plain_rounds": inside["rounds"],
            "launches": used}


def host_work():
    """HOST_WORK float64 matmuls on the host (numpy drops the GIL)."""
    reps, order = HOST_WORK
    a = np.random.default_rng(0).normal(size=(order, order))
    for _ in range(reps):
        a = a @ a
        a /= np.abs(a).max()
    return a


def sessions(dev, n: int, card: str, default: dict, stream: dict) -> dict:
    """Phase 9: sessions at full size on phase 3's rows at k = 256, as a
    user drives them: (a) the default spec's engine, (b) the same with
    ``chunk_size="auto"`` (the stream route), each a ``partition`` (labels
    bitwise phases 6's and 3's) and SESSION_EPOCHS warm ``repartition``
    calls, with a window of LAPs profiled (:func:`warm_session`); (c) an
    ``update`` of (a)'s session, 1 % of the rows out at random and as many
    from ``make("mixture", ..., seed=1)`` in: one ``auction_phase_dense``
    launch on the (B, 256, 256) delta stack, exact balance, the kept rows'
    labels kept, the objective within 1e-3 of a warm full repartition of
    the post-delta rows, the same labels run twice, and an over-threshold
    delta's fallback bitwise that repartition; (d)
    ``dispatch_repartition`` on (a)'s session, its ``wait()`` bitwise the
    synchronous call, with the host time it frees; (e) a warm
    repartition and an update at n = 8 192 on the flat route and on
    ``plan=(8, 16)`` against the forced plain path; (f) the ``greedy`` and
    ``scipy`` solvers on the first LAP of the main data beside the
    auction."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    t_start = time.perf_counter()
    out = {}
    a, eng, states, results = warm_session(
        x, k, dev, card, "a", ("flat", "auction"), "auction_phase_dense",
        "auction", "solve")
    check(a["cold_sha256"] == default["labels_sha256"][:16],
          f"(a) partition's labels {a['cold_sha256']} are not phase 6's "
          f"{default['labels_sha256'][:16]}")
    check(n != PRESETS["diabetes"][0] or a["cold_sha256"] == DEFAULT_DIGEST,
          f"(a) partition's labels {a['cold_sha256']}, expected "
          f"{DEFAULT_DIGEST}")
    out["a"] = a
    b, _, _, _ = warm_session(
        x, k, dev, card, "b", ("stream", "auction_fused"), "auction_phase",
        "auction_fused", "factored", chunk_size="auto")
    check(b["cold_sha256"] == stream["labels_sha256"][:16],
          f"(b) partition's labels {b['cold_sha256']} are not phase 3's "
          f"{stream['labels_sha256'][:16]}")
    out["b"] = b

    # (c) a delta update of (a)'s session
    state = states[-1]
    m = round(n * DELTA_SHARE)
    removed = np.sort(np.random.default_rng(DELTA_SEED).choice(n, m,
                                                               replace=False))
    added = torch.from_numpy(make("mixture", m, d, seed=1)).to(dev)
    keep = np.ones(n, bool)
    keep[removed] = False
    (res_u, new_x, _), upd_s, used = session_call(
        eng.update, x, state, added=added, removed=removed)
    check(res_u.updated, "(c) the update fell back")
    check(used["auction_phase_dense"] == 1 and used["plain_rounds"] == 0,
          f"(c) expected one auction_phase_dense launch: {used}")
    sizes = balanced(res_u.labels, k)
    kept = torch.from_numpy(np.flatnonzero(keep)).to(dev)
    check(torch.equal(res_u.labels[:n - m], state.prev_labels[kept]),
          "(c) a kept row changed its label")
    with PhaseRecorder("auction_phase_dense") as rec:
        res_u2, _, _ = eng.update(x, state, added=added, removed=removed)
    check(torch.equal(res_u.labels, res_u2.labels),
          "(c) the same update gave other labels")
    B = rec.calls[0]["kw"]["cost"].shape[0]
    carried = incremental._carried_state(
        state, n, added, x[torch.from_numpy(removed).to(dev)])
    (res_r, _), rep_s, rep_used = session_call(eng.repartition, new_x,
                                               carried)
    o_u = float(objective_centroid(new_x, res_u.labels, k))
    o_r = float(objective_centroid(new_x, res_r.labels, k))
    check(o_u >= (1.0 - 1e-3) * o_r,
          f"(c) update objective {o_u} below the repartition's {o_r} by "
          f"more than 1e-3")
    fallback = AnticlusterEngine(eng.spec.evolve(update_threshold=0.01),
                                 device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        res_f, _, _ = fallback.update(x, state, added=added, removed=removed)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    check(len(msgs) == 1 and "full warm repartition" in msgs[0]
          and not res_f.updated,
          f"(c) the over-threshold delta did not fall back loudly: {msgs}")
    check(torch.equal(res_f.labels, res_r.labels),
          "(c) the fallback's labels are not the repartition's")
    check(eng.compile_count == 1, f"(c) {eng.compile_count} solve closures")
    whole = call_kernel_ms(x, k, dev, "auction_phase_kernel",
                           call=lambda: eng.update(x, state, added=added,
                                                   removed=removed))
    out["c"] = {"m": m, "B": B, "seconds": upd_s, "repartition_s": rep_s,
                "launches": used, "rounds": used["rounds"],
                "bids": used["bids"],
                "repartition_rounds": rep_used["rounds"], "sizes": sizes,
                "ofv": o_u, "ofv_repartition": o_r, "gap": float(res_u.gap),
                "sha256": digest_of(res_u.labels), "call_profile": whole}
    log(f"(c) update of (a)'s session on {card}: {m} rows out, {m} in: "
        f"{upd_s:.3f} s, one auction_phase_dense launch on the ({B}, {k}, "
        f"{k}) delta stack, {used['rounds']} rounds, {used['bids']} bids; a "
        f"warm repartition of the post-delta rows {rep_s:.3f} s "
        f"({rep_used['rounds']} rounds); sizes {sizes[0]}..{sizes[1]}, "
        f"kept labels kept, ofv {o_u:.6e} against {o_r:.6e} "
        f"({(o_u - o_r) / o_r:+.2e}); the same labels twice; "
        f"update_threshold=0.01 fell back with its warning to the "
        f"repartition's labels")
    log(f"  (c) an update profiled whole: the dense kernel "
        f"{whole['kernel_ms']:.3f} ms of device time, every kernel and copy "
        f"{whole['device_ms']:.3f} ms in {whole['launches']} launches, "
        f"against the update's {upd_s * 1e3:.1f} ms wall; by kernel "
        f"{json.dumps(whole['kernels'])}")

    # (d) dispatch_repartition on (a)'s session, from the state of the
    # call before the last, whose warm result the last call gave: two
    # dispatches (the first starts the worker thread and its stream) and
    # the synchronous call in turns, then one with host work between
    # dispatch and wait
    def dispatched(work=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = eng.dispatch_repartition(x, states[-2])
        dispatch_s = time.perf_counter() - t0
        ready = pending.ready()
        if work is not None:
            work()
        res_d, _ = pending.wait()
        torch.cuda.synchronize()
        check(torch.equal(res_d.labels, results[-1].labels),
              "(d) wait()'s labels are not repartition's")
        return {"ready_at_once": ready, "dispatch_s": dispatch_s,
                "wait_s": time.perf_counter() - t0}

    first = dispatched()
    second = dispatched()
    (res_s, _), sync_s, _ = session_call(eng.repartition, x, states[-2])
    check(torch.equal(res_s.labels, results[-1].labels),
          "(d) the synchronous call gave other labels")
    third = dispatched()
    t0 = time.perf_counter()
    host_work()
    host_s = time.perf_counter() - t0
    both = dispatched(host_work)
    eng.close()
    out["d"] = {"first": first, "second": second, "third": third,
                "repartition_s": sync_s, "host_work_s": host_s,
                "with_host_work": both,
                "overlap_s": sync_s + host_s - both["wait_s"]}
    log(f"(d) dispatch_repartition on (a)'s session, labels bitwise "
        f"repartition's: the first (it starts the worker thread and its "
        f"stream) returned after {first['dispatch_s'] * 1e3:.3f} ms, "
        f"ready() {first['ready_at_once']}, wait() after "
        f"{first['wait_s']:.3f} s; then {second['dispatch_s'] * 1e3:.3f} "
        f"ms / {second['wait_s']:.3f} s, repartition {sync_s:.3f} s, "
        f"{third['dispatch_s'] * 1e3:.3f} ms / {third['wait_s']:.3f} s; "
        f"with {host_s:.3f} s of host work (numpy matmuls) between dispatch "
        f"and wait: {both['wait_s']:.3f} s, {out['d']['overlap_s']:.3f} s "
        f"less than repartition and the host work one after the other")

    # (e) warm and delta paths against the plain path
    xp = torch.from_numpy(make("mixture", PLAIN_SESSION_N, d,
                               seed=1)).to(dev)
    out["e"] = {"flat": session_against_plain(xp, dev, dict(k=k)),
                "hier": session_against_plain(xp, dev,
                                              dict(k=128, plan=(8, 16)))}

    # (f) greedy and scipy on the first LAP of the main data
    _, dist = _centrality(x[None])
    order = torch.argsort(-dist[0], stable=True)
    c, xb = x[order[:k]], x[order[k:2 * k]]
    cost = (-2.0 * xb @ c.T + (c * c).sum(dim=-1)[None])[None].contiguous()
    values, times = {}, {}
    for name in ("auction", "greedy", "scipy"):
        solve = asg.get_solver(name).solve
        assign, _ = solve(cost, asg.AuctionConfig())
        check(torch.equal(torch.sort(assign[0]).values,
                          torch.arange(k, device=dev)),
              f"(f) {name}: not a permutation")
        values[name] = asg.assignment_value(cost[0].cpu().numpy(),
                                            assign[0].cpu().numpy())
        times[name] = time_ms(lambda: solve(cost, asg.AuctionConfig()),
                              reps=5, warmup=1)
    span = float(asg._dense_span(cost)[0])
    slack = span / 4.0  # n * eps_lo = n * span / (eps_end_mul * n)
    check(values["scipy"] >= values["auction"] - slack
          and values["auction"] >= values["scipy"] - slack,
          f"(f) auction {values['auction']} and scipy {values['scipy']} "
          f"more than n * eps_lo = {slack} apart")
    out["f"] = {"values": values, "ms": times, "n_eps_lo": slack}
    log(f"(f) the first LAP of the main data (n={k}): assignment value "
        f"auction {values['auction']:.6e} ({times['auction']:.3f} ms), "
        f"greedy {values['greedy']:.6e} ({times['greedy']:.3f} ms, {k} "
        f"rounds of a masked argmax), scipy {values['scipy']:.6e} "
        f"({times['scipy']:.3f} ms, a host round trip); n * eps_lo "
        f"{slack:.6e}")
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 2, continued, and phase 5: the kernel entry point repro_torch.kernels
# ---------------------------------------------------------------------------

CHUNK_ROWS = 8192          # one streaming chunk of the main path
SSM_SHAPE = (2, 2048, 8192, 16)  # B, S, d_inner, d_state: falcon-mamba-7b
SSM_REPS = dict(reps=3, warmup=1)  # the plain scan loops 2048 steps


def ints(gen, shape, lo, hi, dev):
    return torch.randint(lo, hi, shape, generator=gen).float().to(dev)


def cdist_err(got, want, x_rows, c) -> float:
    """Max |got - want|; raises past 1e-5 (||x||^2 + ||c||^2) + 1e-6 (the
    scale is the norms the entries cancel, not the entries)."""
    tol = 1e-5 * ((x_rows * x_rows).sum(1)[:, None]
                  + (c * c).sum(1)[None, :]) + 1e-6
    diff = (got - want).abs()
    check(bool((diff <= tol).all()), f"cdist float error {diff.max().item()}")
    return diff.max().item()


def top2_err(got, want, what) -> float:
    """bid_top2's tolerance: values within 1e-4*scale + 1e-5*|v|, argmax
    equal where the top-2 gap exceeds 1e-4*scale."""
    (v1, j1, v2), (w1, wj, w2) = got, want
    scale = w1.abs().max().item()
    err = max((v1 - w1).abs().max().item(), (v2 - w2).abs().max().item())
    tol = (1e-4 * scale + 1e-5 * torch.maximum(w1.abs(), w2.abs())).max()
    check(err <= tol.item(), f"{what} float error {err} > {tol.item()}")
    clear = (w1 - w2) > 1e-4 * scale
    check(torch.equal(j1[clear], wj[clear]), f"{what} argmax differs")
    return err


def equal(got, want, what):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{what} differs")


def check_entry_kernels(dev, gen) -> dict:
    """Each new kernel against its plain version; returns the float max
    error of each at its main-path shape."""
    n, d, _ = PRESETS["diabetes"]
    errs = {}
    for dd in (d, 32, 200):
        x, c = ints(gen, (n, dd), -2, 3, dev), ints(gen, (256, dd), -1, 2, dev)
        p = ints(gen, (256,), -2, 3, dev)
        idx = torch.randint(-100, n + 100, (CHUNK_ROWS,), generator=gen).to(dev)
        equal(cuda_cdist(x, c), cdist_ref(x, c), f"cdist d={dd} integers")
        for index in (idx, idx.int()):
            what = f"d={dd} {index.dtype} integers"
            got = cuda_cdist_gather(x, index, c)
            equal(got, cdist_gather_ref(x, index, c), "cdist_gather " + what)
            equal(got, cuda_cdist(cuda_gather_rows(x, index), c),
                  "cdist_gather vs cdist(gather_rows) " + what)
            got = cuda_bid_top2_gather(x, index, c, p)
            equal(got, bid_top2_gather_ref(x, index, c, p),
                  "bid_top2_gather " + what)
            equal(got, cuda_bid_top2(cuda_gather_rows(x, index), c, p),
                  "bid_top2_gather vs bid_top2(gather_rows) " + what)
            equal(got, bid_top2_gather_prev(x, index, c, p),
                  "bid_top2_gather vs its previous design " + what)
    log(f"cdist n={n} k=256, cdist_gather and bid_top2_gather on {CHUNK_ROWS} "
        f"clipped int64/int32 indices, d={d}/32/200, integer inputs: bitwise "
        f"equal to the plain versions and to the kernels on gather_rows "
        f"(bid_top2_gather also to its previous design)")

    x = torch.randn((n, d), generator=gen).to(dev)
    c = torch.randn((256, d), generator=gen).to(dev)
    p = torch.randn((256,), generator=gen).to(dev)
    idx = torch.randint(-100, n + 100, (CHUNK_ROWS,), generator=gen).to(dev)
    rows = gather_rows_ref(x, idx)
    errs["cdist"] = cdist_err(cuda_cdist(x, c), cdist_ref(x, c), x, c)
    errs["cdist_gather"] = cdist_err(cuda_cdist_gather(x, idx, c),
                                     cdist_gather_ref(x, idx, c), rows, c)
    equal(cuda_cdist_gather(x, idx, c),
          cuda_cdist(cuda_gather_rows(x, idx), c), "cdist_gather floats")
    errs["bid_top2_gather"] = top2_err(cuda_bid_top2_gather(x, idx, c, p),
                                       bid_top2_gather_ref(x, idx, c, p),
                                       "bid_top2_gather")
    equal(cuda_bid_top2_gather(x, idx, c, p),
          cuda_bid_top2(cuda_gather_rows(x, idx), c, p),
          "bid_top2_gather floats")
    for index in (idx, idx.int()):  # and c staged by the threads
        got = cuda_bid_top2_gather(x, index, c, p)
        for cc in (c, off_grid(c)):
            equal(cuda_bid_top2_gather(x, index, cc, p), got,
                  f"bid_top2_gather floats, {index.dtype}, c at "
                  f"{cc.data_ptr() % 16}")
            equal(bid_top2_gather_prev(x, index, cc, p), got,
                  f"bid_top2_gather's previous design, {index.dtype}")
    wide_idx = torch.randint(-100, n + 100, (GATHER_WIDE_M,),
                             generator=gen).to(dev)
    got = cuda_bid_top2_gather(x, wide_idx, c, p)
    equal(got, cuda_bid_top2(cuda_gather_rows(x, wide_idx), c, p),
          f"bid_top2_gather floats at m={GATHER_WIDE_M}")
    equal(got, bid_top2_gather_prev(x, wide_idx, c, p),
          f"bid_top2_gather's previous design at m={GATHER_WIDE_M}")
    top2_err(got, bid_top2_gather_ref(x, wide_idx, c, p),
             f"bid_top2_gather at m={GATHER_WIDE_M}")
    log(f"Gaussian floats: cdist max_abs_err {errs['cdist']:.3e}, "
        f"cdist_gather {errs['cdist_gather']:.3e} (tol 1e-5*(|x|^2+|c|^2)"
        f"+1e-6), bid_top2_gather {errs['bid_top2_gather']:.3e} (bid_top2's "
        f"tol, argmax equal where the gap > 1e-4*scale); both fused kernels "
        f"bitwise equal to the unfused kernel on gather_rows; "
        f"bid_top2_gather bitwise its previous design with int64 and int32 "
        f"indices, with c on and off the 16-byte grid, and at "
        f"m={GATHER_WIDE_M}")

    args = ssm_inputs(gen, SSM_SHAPE, dev)
    y, h = K.ssm_scan(*args)
    want_y, want_h = ssm_scan_ref(*args)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    errs["ssm_scan"] = max((y - want_y).abs().max().item(),
                           (h - want_h).abs().max().item())
    small = ssm_inputs(gen, (2, 64, 512, 16), dev)
    tm = [t.transpose(0, 1).contiguous() for t in small[:4]]
    h0 = torch.randn((2, 512, 16), generator=gen).to(dev)
    got, want = ssm_scan_chunk(*tm, small[4], h0), ssm_scan_chunk_ref(
        *tm, small[4], h0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    log(f"ssm_scan B,S,di,ds={SSM_SHAPE}: within rtol/atol 1e-4 of "
        f"ssm_scan_ref, max_abs_err {errs['ssm_scan']:.3e}; ssm_scan_chunk "
        f"C=64 B=2 di=512 ds=16 from a nonzero h0: within rtol/atol 1e-4")

    wide = torch.randn((4096, 600), generator=gen).to(dev)
    cw, pw = wide[:64].clone(), torch.randn((64,), generator=gen).to(dev)
    iw = torch.randint(0, 4096, (1024,), generator=gen).to(dev)
    reset_counts()
    dist, bids = K.cdist(wide, cw, idx=iw), K.bid_top2(wide, cw, pw, idx=iw)
    used = counts()
    check(used["gather_rows"] == 2 and used["cdist"] == 1
          and used["bid_top2"] == 1 and used["cdist_gather"] == 0
          and used["bid_top2_gather"] == 0,
          f"d=600 did not take gather + unfused kernels: {used}")
    cdist_err(dist, cdist_gather_ref(wide, iw, cw), wide[iw], cw)
    top2_err(bids, bid_top2_gather_ref(wide, iw, cw, pw), "bid_top2 d=600")
    log(f"d=600: cdist(idx=) / bid_top2(idx=) took gather_rows + the unfused "
        f"kernels (launches {used})")
    return errs


def ssm_inputs(gen, shape, dev):
    bsz, s, di, ds = shape
    dt = torch.rand((bsz, s, di), generator=gen) * 0.1
    b, c = (torch.randn((bsz, s, ds), generator=gen) for _ in range(2))
    x = torch.randn((bsz, s, di), generator=gen)
    a = -torch.rand((di, ds), generator=gen) * 4.0
    return [t.to(dev) for t in (dt, b, c, x, a)]


def entry_inputs(dev) -> dict:
    """Phase 5's inputs, made from a seed: the diabetes rows, 256 centroids
    drawn from them, prices, one chunk's 8192 indices, a scan's inputs."""
    gen = torch.Generator().manual_seed(5)
    n, d, _ = PRESETS["diabetes"]
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    return {"x": x, "c": x[torch.randperm(n, generator=gen)[:256].to(dev)],
            "p": torch.rand((256,), generator=gen).to(dev),
            "idx": torch.randperm(n, generator=gen)[:CHUNK_ROWS].to(dev),
            "ssm": ssm_inputs(gen, SSM_SHAPE, dev)}


def entry_point(dev) -> dict:
    """The entry point as a user calls it, at full size, with the counters
    zeroed just before and read just after."""
    inp = entry_inputs(dev)
    x, c, p, idx = inp["x"], inp["c"], inp["p"], inp["idx"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    dist = K.cdist(x, c)
    chunk_dist = K.cdist(x, c, idx=idx)
    bids = K.bid_top2(x, c, p, idx=idx)
    y, h = K.ssm_scan(*inp["ssm"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    used = counts()
    for name in ("cdist", "cdist_gather", "bid_top2_gather", "ssm_scan"):
        check(used[name] > 0, f"{name} not launched by the entry point")
    n = x.shape[0]
    bsz, s, di, ds = SSM_SHAPE
    check(dist.shape == (n, 256) and chunk_dist.shape == (CHUNK_ROWS, 256)
          and y.shape == (bsz, s, di) and h.shape == (bsz, di, ds),
          "entry point output shapes")
    check(all(bool(t.isfinite().all()) for t in (dist, chunk_dist, *bids, y, h)),
          "entry point outputs not finite")
    check(bool((dist.min(1).values > -1e-3).all()), "negative distances")
    check(torch.equal(chunk_dist, dist[idx]), "cdist(idx=) != cdist rows")
    check(bool((bids[0] >= bids[2]).all()) and bool((bids[1] >= 0).all())
          and bool((bids[1] < 256).all()), "bid_top2(idx=) not a top-2")
    log(f"entry point n={n} d={x.shape[1]} k=256 idx={CHUNK_ROWS} "
        f"ssm={SSM_SHAPE}: {run_s:.3f} s, launches {used}")
    return {"seconds": run_s, "launches": used}


def measure_entry_kernels(dev, errs) -> list:
    """Each of the entry point's kernels timed on phase 5's inputs."""
    inp = entry_inputs(dev)
    x, c, p, idx, ssm = (inp[k] for k in ("x", "c", "p", "idx", "ssm"))
    n, d = x.shape
    rows = []
    xn, cn = (x * x).sum(1), (c * c).sum(1)
    m, k = n, 256
    b_cd, by_cd = bound_ms(4 * (m * d + k * d + m * k),
                           2 * m * k * d + 2 * (m + k) * d + 3 * m * k)
    rows.append(timed_row(
        "cdist", "cdist.cu", "src/repro/kernels/cdist.py:29",
        f"m={m} n={k} d={d}", errs, lambda: cuda_cdist(x, c), "cdist_kernel",
        lambda: cdist_ref(x, c),
        lambda: torch.addmm(xn[:, None] + cn, x, c.T, alpha=-2.0),
        b_cd, by_cd))
    mi = CHUNK_ROWS
    b_cg, by_cg = bound_ms(8 * mi + 4 * (mi * d + k * d + mi * k),
                           2 * mi * k * d + 2 * (mi + k) * d + 3 * mi * k)
    clipped = idx.clamp(0, n - 1)
    rows.append(timed_row(
        "cdist_gather", "cdist_gather.cu", "src/repro/kernels/gather.py:238",
        f"n={n} m={mi} nc={k} d={d} (int64 idx)", errs,
        lambda: cuda_cdist_gather(x, idx, c), "cdist_kernel",
        lambda: cdist_gather_ref(x, idx, c),
        lambda: torch.addmm(xn[clipped][:, None] + cn,
                            torch.index_select(x, 0, clipped), c.T,
                            alpha=-2.0), b_cg, by_cg))
    rows.append(measure_bid_top2_gather(dev, x, c, p, idx, errs))
    bsz, s, di, ds = SSM_SHAPE
    b_ss, by_ss = bound_ms(4 * (3 * bsz * s * di + 2 * bsz * s * ds + di * ds
                                + bsz * di * ds),
                           7 * bsz * s * di * ds + bsz * s * di)
    rows.append(timed_row(
        "ssm_scan", "ssm_scan.cu", "src/repro/kernels/ssm_scan.py:28",
        "B={} S={} di={} ds={}".format(*SSM_SHAPE), errs,
        lambda: K.ssm_scan(*ssm), "ssm_scan_kernel",
        lambda: ssm_scan_ref(*ssm), None, b_ss, by_ss, plain_reps=SSM_REPS))
    # beside the bytes: one expf a state and step, each a MUFU.EX2
    expf = bsz * s * di * ds
    rows[-1]["expf"] = expf
    clock, max_clock = sm_clock_mhz(lambda: K.ssm_scan(*ssm))

    def floor_ms(mhz):
        return expf / (SMS * EX2_PER_CLOCK_PER_SM * mhz * 1e6) * 1e3

    at_clock = ("not measured (the card ran out of queued calls while the "
                "clock was read)" if clock is None else
                f"{floor_ms(clock):.4f} ms at {clock} MHz")
    log(f"ssm_scan: bytes bound {b_ss:.4f} ms; {expf} expf, special-function "
        f"floor {floor_ms(BOOST_SM_MHZ):.4f} ms at the data sheet's "
        f"{BOOST_SM_MHZ} MHz, {at_clock}, the SM clock read while calls ran "
        f"(max {max_clock} MHz)")
    return rows


SSM_TRAIN_SHAPE = (2, 4096, 8192, 16)  # phase 16's layer: B, S, di, ds
SSM_BWD_PLAIN_REPS = dict(reps=1, warmup=0)  # the plain walk: 4096 steps, 2 s
SSM_BWD_REL = 1e-4  # of each gradient's max |.|: the sums' order differs
SSM_BWD_FLOPS = 20  # a state and step: h again, g, the five terms, decay
# The backward kernel's previous design (a CTA a tile summing the tile's
# partials on the walk), timed beside the current one as a yardstick: its
# source at commit SSM_BWD_PARENT, from `git show` in a git checkout, else
# from SSM_BWD_PARENT_COPY (a git-ignored copy placed there by hand).
SSM_BWD_PARENT = "f7e50f5"
SSM_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu"
SSM_BWD_PARENT_COPY = os.path.join(ROOT, "build", "baseline",
                                   f"ssm_scan_bwd-{SSM_BWD_PARENT}.cu")


def start_parent_bwd_build() -> dict:
    """Start nvcc on the previous design's ssm_scan_bwd.cu in a temporary
    directory outside the tree (with the port's flags); returns what
    :func:`parent_bwd` needs, or the reason it cannot be built."""
    src = None
    if os.path.exists(os.path.join(ROOT, ".git")):
        got = subprocess.run(
            ["git", "-C", ROOT, "show", f"{SSM_BWD_PARENT}:{SSM_BWD_SOURCE}"],
            capture_output=True, text=True, timeout=60)
        src = got.stdout if got.returncode == 0 else None
    if src is None and os.path.exists(SSM_BWD_PARENT_COPY):
        with open(SSM_BWD_PARENT_COPY) as f:
            src = f.read()
    if src is None:
        return {"reason": f"not measured: no git history and no "
                          f"{os.path.relpath(SSM_BWD_PARENT_COPY, ROOT)}"}
    nvcc = _build._nvcc()
    tmp = tempfile.mkdtemp(prefix="ssm_scan_bwd_parent_")
    cu, lib = os.path.join(tmp, "ssm_scan_bwd.cu"), os.path.join(tmp, "lib.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", lib,
                             cu], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "lib": lib, "dir": tmp}


def parent_bwd(build: dict):
    """The previous design's ssm_scan_bwd as a callable of the wrapper's
    arguments (B, S, .) layout, allocating its scratch and zeroed counters
    as its wrapper did, and its scratch in bytes; or (None, reason)."""
    if "proc" not in build:
        return None, build["reason"]
    out, _ = build["proc"].communicate()
    try:
        if build["proc"].returncode:
            return None, f"not measured: nvcc exited " \
                         f"{build['proc'].returncode}: {out[-2000:]}"
        lib = ctypes.CDLL(build["lib"])
    finally:
        shutil.rmtree(build["dir"], ignore_errors=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn, ws = lib.ssm_scan_bwd_f32, lib.ssm_scan_bwd_workspace_f32
    fn.argtypes = (P,) * 6 + (I,) + (P,) * 10 + (I,) * 4 + (L,) * 4 + (P,)
    ws.argtypes = (I, I, I, I, P, P)
    fn.restype = ws.restype = ctypes.c_int

    def call(dt, b_in, c_out, x_in, a_mat, h_tiles, dy, dh):
        bsz, s, di = dt.shape
        ds = a_mat.shape[1]
        part, count = ctypes.c_int64(), ctypes.c_int64()
        check(ws(bsz, s, di, ds, ctypes.addressof(part),
                 ctypes.addressof(count)) == 0, "parent workspace query")
        work = torch.empty((part.value,), dtype=torch.float32,
                           device=dt.device)
        counters = torch.zeros((count.value,), dtype=torch.int32,
                               device=dt.device)
        outs = [torch.empty_like(t) for t in (dt, b_in, c_out, x_in)]
        da = torch.empty_like(a_mat)
        dh0 = torch.empty_like(dh)
        st, sb = (di, s * di), (ds, s * ds)  # (time, batch) strides
        err = fn(*(t.data_ptr() for t in (dt, b_in, c_out, x_in, a_mat,
                                          h_tiles)), h_tiles.shape[1],
                 *(t.data_ptr() for t in (dy, dh, outs[0], outs[1], outs[2],
                                          outs[3], da, dh0, work, counters)),
                 bsz, s, di, ds, *st, *sb,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"parent ssm_scan_bwd launch: cudaError {err}")
        return (*outs, da, dh0), 4 * (part.value + count.value)
    return call, None


SSM_BWD_F64_SHAPE = (1, 4096, 512, 16)  # falcon's S and d_state, 512 channels


def ssm_bwd_f64_errors(dev, parent) -> dict:
    """Each gradient's largest error over its max |.| against the plain
    walk in float64 at SSM_BWD_F64_SHAPE: the kernel's, the previous
    design's (``parent``, or None) and the float32 plain walk's.  The
    previous design forms exp(dt A) with expf, as the float32 walk does,
    so those two agree more closely with each other than with float64."""
    bsz, s, di, ds = SSM_BWD_F64_SHAPE
    gen = torch.Generator().manual_seed(64)
    args = ssm_inputs(gen, SSM_BWD_F64_SHAPE, dev)
    dy = torch.randn((bsz, s, di), generator=gen).to(dev)
    dh = torch.randn((bsz, di, ds), generator=gen).to(dev)
    tiles = ssm_scan_train(*args)[2]
    wide = ssm_scan_bwd_ref(*(t.double() for t in (*args, dy, dh)))
    runs = {"kernel": ssm_scan_bwd(*args, tiles, dy, dh),
            "plain_f32": ssm_scan_bwd_ref(*args, dy, dh)}
    if parent is not None:
        runs["previous"] = parent(*args, tiles, dy, dh)[0]
    return {what: {n: (g.double() - w).abs().max().item()
                   / w.abs().max().item()
                   for n, g, w in zip(("ddt", "db", "dc", "dx", "da"), got,
                                      wide)}
            for what, got in runs.items()}


def check_and_measure_ssm_scan_bwd(dev, parent_build: dict) -> dict:
    """The backward scan at phase 16's layer shape (falcon-mamba-7b's
    width at S = 4 096) against ``ssm_scan_bwd_ref``: every gradient
    within SSM_BWD_REL of its max |.|, a second launch bitwise the first;
    the saving forward's y and h bitwise the serving launch's.  Then its
    time, the plain walk's, the saving forward's beside the serving one,
    and the bound: the bytes (dt, x, dy read, d(dt), dx written, the
    saved states read; B, C and their gradients) against SSM_BWD_FLOPS
    float32 operations a state and step, and its expf floor (one a state
    and step) at the data sheet's clock; its scratch.  Beside it the
    previous design (``parent_build``, :func:`start_parent_bwd_build`),
    checked against the same plain walk and timed in turns with it; all
    three against the plain walk in float64 (:func:`ssm_bwd_f64_errors`)."""
    bsz, s, di, ds = SSM_TRAIN_SHAPE
    gen = torch.Generator().manual_seed(16)
    args = ssm_inputs(gen, SSM_TRAIN_SHAPE, dev)
    dy = torch.randn((bsz, s, di), generator=gen).to(dev)
    dh = torch.randn((bsz, di, ds), generator=gen).to(dev)
    y, h, tiles = ssm_scan_train(*args)
    y0, h0 = K.ssm_scan(*args)
    check(torch.equal(y, y0) and torch.equal(h, h0),
          "ssm_scan's saving launch differs from the serving launch")
    got = ssm_scan_bwd(*args, tiles, dy, dh)
    again = ssm_scan_bwd(*args, tiles, dy, dh)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          "ssm_scan_bwd not repeatable bit for bit")
    want = ssm_scan_bwd_ref(*args, dy, dh)
    names = ("ddt", "db", "dc", "dx", "da")
    errs, rels = {}, {}
    for name, g, w in zip(names, got, want):
        errs[name] = (g - w).abs().max().item()
        rels[name] = errs[name] / w.abs().max().item()
    check(max(rels.values()) <= SSM_BWD_REL,
          f"ssm_scan_bwd against its plain version: {rels}")
    parent, why = parent_bwd(parent_build)
    parent_rel, parent_scratch = None, None
    if parent is not None:
        old, parent_scratch = parent(*args, tiles, dy, dh)
        parent_rel = max((g - w).abs().max().item() / w.abs().max().item()
                         for g, w in zip(old, want))
        check(parent_rel <= SSM_BWD_REL,
              f"the previous ssm_scan_bwd against the plain walk: "
              f"{parent_rel}")
        del old
    del want, again
    n = bsz * s * di * ds
    n_bytes = 4 * (5 * bsz * s * di + 4 * bsz * s * ds
                   + bsz * -(-s // 16) * di * ds + 2 * di * ds
                   + 2 * bsz * di * ds)
    b, by = bound_ms(n_bytes, SSM_BWD_FLOPS * n)
    fn = lambda: ssm_scan_bwd(*args, tiles, dy, dh)  # noqa: E731
    old_fn = (None if parent is None
              else functools.partial(parent, *args, tiles, dy, dh))
    # in turns: the previous design, this one, this one, the previous
    parent_ms = [] if old_fn is None else [time_ms(old_fn)]
    ms_turns = [time_ms(fn), time_ms(fn)]
    if old_fn is not None:
        parent_ms.append(time_ms(old_fn))
    row = {"name": "ssm_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
           "replaces": "src/repro/models/mamba.py:114 (the gradient of "
                       "mamba_apply's lax.scan; ssm_scan.py:55 has none)",
           "shape": "B={} S={} di={} ds={}".format(*SSM_TRAIN_SHAPE),
           "max_abs_err": max(errs.values()), "max_rel_err": rels,
           "ms": ms_turns[0], "ms_again": ms_turns[1],
           "device_ms": device_ms(fn, "ssm_scan_bwd"),
           "walk_device_ms": device_ms(fn, "ssm_scan_bwd_kernel<"),
           "sums_device_ms": device_ms(fn, "ssm_scan_bwd_kernel_sums"),
           "scratch_bytes": 4 * workspace_floats(bsz, s, di, ds),
           "parent": SSM_BWD_PARENT, "parent_ms": parent_ms or why,
           "parent_scratch_bytes": parent_scratch,
           "parent_max_rel_err": parent_rel,
           "f64_rel_err": ssm_bwd_f64_errors(dev, parent),
           "plain_ms": time_ms(lambda: ssm_scan_bwd_ref(*args, dy, dh),
                               **SSM_BWD_PLAIN_REPS),
           "bound_ms": b, "bound_by": by,
           "expf_floor_ms": n / (SMS * EX2_PER_CLOCK_PER_SM * BOOST_SM_MHZ
                                 * 1e6) * 1e3,
           "library_ms": None,
           "saving_forward_ms": time_ms(lambda: ssm_scan_train(*args)),
           "serving_forward_ms": time_ms(lambda: K.ssm_scan(*args))}
    log(f"ssm_scan_bwd {row['shape']}: each gradient within "
        f"{SSM_BWD_REL} of its max |.| of ssm_scan_bwd_ref ({rels}), "
        f"max_abs_err {row['max_abs_err']:.3e}; repeatable bit for bit; "
        f"kernel {row['ms']:.4f}, {row['ms_again']:.4f} ms (device "
        f"{row['device_ms']} ms: the walk {row['walk_device_ms']}, the "
        f"sums {row['sums_device_ms']}), scratch {row['scratch_bytes']} "
        f"bytes; the previous design ({SSM_BWD_PARENT}) in turns "
        f"{row['parent_ms']} ms, scratch {parent_scratch} bytes, within "
        f"{parent_rel} of the plain walk; against the plain walk in "
        f"float64 at {SSM_BWD_F64_SHAPE}: {row['f64_rel_err']}; plain "
        f"{row['plain_ms']:.1f} ms, bound {b:.4f} ms ({by}), expf floor "
        f"{row['expf_floor_ms']:.4f} ms at {BOOST_SM_MHZ} MHz; the forward "
        f"saving its states every 16 steps {row['saving_forward_ms']:.4f} "
        f"ms against {row['serving_forward_ms']:.4f} ms serving, y and h "
        f"bitwise equal")
    return row


def sm_clock_mhz(fn) -> tuple[int | None, int]:
    """The SM clock nvidia-smi reads while queued calls of ``fn`` keep the
    card busy, and the card's maximum SM clock, in MHz.  Calls are queued
    until the reading returns; the first is None if the queue ran dry on
    the way (the card idled, so the clock read may be an idle one)."""
    for _ in range(100):
        fn()
    last = torch.cuda.Event()
    last.record()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], stdout=subprocess.PIPE, text=True)
    busy = True
    while smi.poll() is None:
        busy &= not last.query()  # the calls queued so far are not all done
        fn()
        last = torch.cuda.Event()
        last.record()
    out = smi.communicate(timeout=60)[0].strip().splitlines()[0]
    torch.cuda.synchronize()
    check(smi.returncode == 0, f"nvidia-smi exited {smi.returncode}")
    clock, max_clock = (int(v) for v in out.split(","))
    return (clock if busy else None), max_clock


GATHER_WIDE_M = 65536  # bid_top2_gather's second shape: 8 tiles a CTA
# the kernels' names in the profiler: this design's, and the previous
# design's (bid_top2.cuh's kernel, which the unfused bid_top2 launches too)
GATHER_KERNEL = "bid_top2_gather_kernel"
GATHER_PREV_KERNEL = "bid_top2_kernel"


def gather_bound(m, k, d) -> tuple[float, str]:
    """bid_top2_gather's bound: m int64 indices, the m rows, c and p read,
    three (m,) outputs written; an FMA a row, column and feature, a
    column's norm, and the top-2 step of each row and column."""
    return bound_ms(8 * m + 4 * (m * d + k * d + k) + m * 16,
                    2 * m * k * d + 2 * k * d + 2 * m * k)


def stage_cycles(stamps) -> dict:
    """Per stage of the timed instantiation, the median and the maximum
    over CTAs of its SM cycles (``tiles``: of the tiles a CTA took)."""
    out = {"ctas": stamps.shape[0]}
    for i, name in enumerate(GATHER_STAGES):
        col = stamps[:, i].double()
        out[name] = {"median": float(col.median()), "max": float(col.max())}
    return out


def measure_bid_top2_gather(dev, x, c, p, idx, errs) -> dict:
    """bid_top2_gather on phase 5's chunk and on GATHER_WIDE_M indices:
    this design and the previous one in turns (this, previous, previous,
    this) by CUDA events and then by the profiler's device time a launch
    (:func:`launch_device_ms`), beside
    the bound, the plain version and the library call (``index_select`` +
    ``addmm`` + ``topk(2)``, timed in the same run), with c off the 16-byte
    grid (staged by the threads), and the stages' cycles per CTA from the
    timed instantiation."""
    n, d = x.shape
    k = c.shape[0]
    cn = (c * c).sum(1)
    c_staged = off_grid(c)
    wide_idx = torch.randperm(n, generator=torch.Generator().manual_seed(
        32))[:GATHER_WIDE_M].to(dev)
    out = {}
    for m, index in ((idx.shape[0], idx), (GATHER_WIDE_M, wide_idx)):
        clipped = index.clamp(0, n - 1)

        def new():
            return cuda_bid_top2_gather(x, index, c, p)

        def prev():
            return bid_top2_gather_prev(x, index, c, p)

        def library():  # yardstick only
            return torch.topk(torch.addmm(cn - p, torch.index_select(
                x, 0, clipped), c.T, alpha=-2.0), 2, dim=1)

        ms = [time_ms(new), time_ms(prev), time_ms(prev), time_ms(new)]
        readings = [launch_device_ms(new, GATHER_KERNEL),
                    launch_device_ms(prev, GATHER_PREV_KERNEL),
                    launch_device_ms(prev, GATHER_PREV_KERNEL),
                    launch_device_ms(new, GATHER_KERNEL)]
        dms = [t for t, _ in readings]
        for _ in range(3):  # warm
            _, stamps = bid_top2_gather_timed(x, index, c, p)
        torch.cuda.synchronize()
        b, by = gather_bound(m, k, d)
        r = {"shape": f"n={n} m={m} k={k} d={d} (int64 idx)",
             "ms_turns": ms, "device_ms_turns": dms,
             "device_launches_recorded": [n for _, n in readings],
             "ms": min(ms[0], ms[3]), "prev_ms": min(ms[1], ms[2]),
             "device_ms": min((t for t in (dms[0], dms[3]) if t is not None),
                              default=None),
             "prev_device_ms": min((t for t in (dms[1], dms[2])
                                    if t is not None), default=None),
             "bound_ms": b, "bound_by": by,
             "library_ms": time_ms(library),
             "library_device_ms": device_ms(library, ""),
             "staged_device_ms": launch_device_ms(
                 lambda: cuda_bid_top2_gather(x, index, c_staged, p),
                 GATHER_KERNEL)[0],
             "prev_staged_device_ms": launch_device_ms(
                 lambda: bid_top2_gather_prev(x, index, c_staged, p),
                 GATHER_PREV_KERNEL)[0],
             "stage_cycles": stage_cycles(stamps.cpu())}
        r["bound_share"] = (b / r["device_ms"] if r["device_ms"] else None)
        out[m] = r
        sc = r["stage_cycles"]
        log(f"bid_top2_gather {r['shape']}: in turns (this, previous, "
            f"previous, this) event ms {', '.join(f'{t:.4f}' for t in ms)}; "
            f"device ms {dms}; bound {b:.6f} ms ({by}), share "
            f"{r['bound_share']}; c off the 16-byte grid device "
            f"{r['staged_device_ms']} (previous {r['prev_staged_device_ms']});"
            f" index_select + addmm + topk(2) {r['library_ms']:.4f} ms "
            f"(device {r['library_device_ms']}, per call); device "
            f"launches recorded of 20 {r['device_launches_recorded']}")
        log(f"bid_top2_gather {r['shape']} stages (SM cycles a CTA, median "
            f"/ max over {sc['ctas']} CTAs): " + ", ".join(
                f"{name} {sc[name]['median']:.0f} / {sc[name]['max']:.0f}"
                for name in GATHER_STAGES))
    main = out[idx.shape[0]]
    row = {"name": "bid_top2_gather", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/bid_top2_gather.cu",
           "replaces": "src/repro/kernels/gather.py:129",
           "max_abs_err": errs["bid_top2_gather"],
           "plain_ms": time_ms(lambda: bid_top2_gather_ref(x, idx, c, p)),
           "launches_in": "phase 5: the repro_torch.kernels entry point "
                          "(no anticluster path runs this kernel)",
           **main, f"m{GATHER_WIDE_M}": out[GATHER_WIDE_M]}
    return row


def timed_row(name, source, replaces, shape, errs, fn, kernel, plain,
              library, b, by, plain_reps=None) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "shape": shape,
            "max_abs_err": errs[name], "ms": time_ms(fn),
            "device_ms": device_ms(fn, kernel),
            "plain_ms": time_ms(plain, **(plain_reps or {})),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(library) if library else None,
            "library_device_ms": device_ms(library, "") if library else None,
            "launches_in": "phase 5: the repro_torch.kernels entry point "
                           "(no anticluster path runs this kernel)"}


def log_rows(rows):
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms (device "
                    f"{r.get('library_device_ms')} ms)")
        log(f"{r['name']} {r['shape']}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")


# ---------------------------------------------------------------------------
# phase 10: the consumers at full size
# ---------------------------------------------------------------------------

SEQ_BATCH = 512         # (a): examples a step, k = 495 on the diabetes rows
SEQ_DRIFT = (0.01, 11)  # (a): the epochs' features x + 0.01 N(0, 1), seed
SEQ_GROW = 2537         # (a): rows the sequencer grows by (1 %), seed 1
FOLDS = 10              # (b): k of the folds
FOLD_DELTA_SEED = 12    # (b): which rows the live folds lose
ROUTER_K = 256          # (c)
ROUTER_BURST = 32       # (c): requests of the burst
ROUTER_ROWS = (12288, 16384)  # (c): their row counts, one 16 384-row bucket
ROUTER_SEED = 5
ROUTER_GROUP = 8        # (c): the stacked setting's max_group
LIVE_ROWS = 16384       # (c): the live partition's rows


class _FirstLap(Exception):
    """Stops a solve once its first LAP is recorded (phase 2)."""


def check_rounds_g(calls, what, dense=False) -> int:
    """Each recorded phase-kernel call again with ``return_rounds``: its
    assignment and prices bitwise the loop's, and its (P, G) ``rounds_g``
    group by group equal to the plain twin's exact count (the loop over
    the CUDA bid_top2 for the factored kernel, ``ref.top2`` for the dense
    one), so ``rounds_g.amax(1)`` is the telemetry's ``rounds``.  Returns
    the calls checked."""
    for i, call in enumerate(calls):
        kw = call["kw"]
        if dense:
            got = phase_kernel.auction_phase_dense(**kw, return_rounds=True)
            want = ref.auction_phase_dense_ref(**kw, return_rounds=True)
        else:
            got = phase_kernel.auction_phase(**kw, return_rounds=True)
            want = ref.auction_rounds(
                ref.factored_top2(kw["x"], kw["c"], kw["is_real"],
                                  cuda_bid_top2),
                kw["prices"], kw["eps"], kw["max_rounds"],
                kw["fixed_rounds"], kw["skip"], kw["seed_top2"], True)
            want = (*want[:2], want[2][None])
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{what}, call {i}: the kernel differs from the loop")
        check(torch.equal(got[2], want[2]),
              f"{what}, call {i}: rounds_g {got[2].tolist()} against the "
              f"plain twin's {want[2].tolist()}")
    return len(calls)


def first_lap(fn, name: str = "auction_phase", calls: int = 4) -> list:
    """The first ``calls`` calls of ``ops.<name>`` that ``fn()`` makes (a
    factored LAP's four phases, or a dense LAP's one launch), recorded by
    :class:`PhaseRecorder`; ``fn`` is stopped at the next call."""
    def keep(kw):
        if len(rec.calls) == calls:
            raise _FirstLap
        return True

    rec = PhaseRecorder(name, keep=keep)
    try:
        with rec:
            fn()
    except _FirstLap:
        pass
    check(len(rec.calls) == calls, f"{len(rec.calls)} {name} calls recorded")
    return rec.calls


def check_sequencer_lap(dev) -> dict:
    """Phase 2 at phase 10's sequencer shape (k = 495, the stream route,
    ``"auction_fused"``): the factored kernel bitwise the loop on every
    phase of the sequencer's first LAP with equal rounds, bids and
    single-bidder rounds, its ``rounds_g`` the plain twin's exact count,
    and the span's pair there against its plain version.  Then the dense
    kernel's ``rounds_g`` on a G = 3 warm stack of the same LAP with skips,
    ``fixed_rounds`` and a biting ``max_rounds``."""
    n, d, _ = PRESETS["diabetes"]
    k = n // SEQ_BATCH
    x = torch.from_numpy(make("mixture", n, d, seed=0)[:k * SEQ_BATCH]
                         ).to(dev)
    # the sequencer's solve: chunk_size="auto" is 8192 rows
    calls = first_lap(lambda: aba_stream(x, k, 8192, solver="auction_fused",
                                         device=dev))
    what = f"the sequencer's first LAP (n={k} d={d})"
    check_phase_calls(calls, what)
    check_rounds_g(calls, what)
    err = check_span([calls[0]["kw"]], what)
    xs = calls[0]["kw"]["x"][0]
    cs = calls[0]["kw"]["c"][0]
    cost = (-2.0 * xs @ cs.T + (cs * cs).sum(1)[None])[None].repeat(3, 1, 1)
    warm = calls[-1]["out"][1].repeat(3, 1)
    warm[0] = 0.0  # one cold group beside two warm ones
    checked = 0
    for cfg in (asg.AuctionConfig(), asg.AuctionConfig(fixed_rounds=40),
                asg.AuctionConfig(max_rounds=7)):
        with PhaseRecorder("auction_phase_dense") as dense:
            asg.auction_solve(cost, cfg, prices=warm, device=dev)
        checked += check_rounds_g(dense.calls, f"{what} as a G=3 dense "
                                  f"stack, {cfg}", dense=True)
    rounds = [int(c["rounds"]) for c in calls]
    log(f"auction_phase on {what}: 4 phases bitwise the every-round loop "
        f"over bid_top2, rounds {rounds}, rounds_g the plain twin's exact "
        f"count; auction_phase_dense rounds_g equal on {checked} G=3 warm "
        f"launches (skip, fixed_rounds=40, max_rounds=7); span pair "
        f"max_abs_err {err:.3e}")
    return {"k": k, "rounds": rounds, "span_err": err,
            "dense_launches_checked": checked}


def check_mesh_laps(dev) -> dict:
    """Phase 2 at phase 11's mesh shapes, on phase 3's rows and a 2-shard
    mesh of the one card: the first LAP of shard 0 of the mesh call
    ``anticluster(x, k=256, mesh=..., chunk_size="auto")`` (k_local = 128,
    streamed) and of the mesh sequencer's partition (batch_size 480:
    k_local = 264, streamed), each recorded inside the mesh route: the
    factored kernel bitwise the every-round loop on every phase with equal
    rounds, bids and single-bidder rounds, its ``rounds_g`` the plain twin's
    exact count, the span's pair against its plain version; then the first
    LAP of the router lane's request (MESH_ROUTER_ROWS rows, flat, n = 128):
    the dense kernel bitwise the loop over ``ref.top2`` and its
    ``rounds_g``."""
    n, d, _ = PRESETS["diabetes"]
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    mesh2 = make_host_mesh(2, 1, device=dev)
    out = {}
    for name, fn, k_local in (
            ("two_shards", lambda: anticluster(x, k=MESH_K, mesh=mesh2,
                                               chunk_size="auto", device=dev),
             MESH_K // 2),
            ("sequencer", lambda: ABABatchSequencer(x, MESH_SEQ_BATCH,
                                                    mesh=mesh2, device=dev),
             n // MESH_SEQ_BATCH // 2)):
        calls = first_lap(fn)
        shape = tuple(calls[0]["kw"]["x"].shape)
        check(shape == (1, k_local, d),
              f"the mesh {name}'s first LAP has x {shape}, not "
              f"{(1, k_local, d)}")
        what = f"the mesh {name}'s first LAP on shard 0 (n={k_local} d={d})"
        check_phase_calls(calls, what)
        check_rounds_g(calls, what)
        err = check_span([calls[0]["kw"]], what)
        rounds = [int(c["rounds"]) for c in calls]
        log(f"auction_phase on {what}: 4 phases bitwise the every-round "
            f"loop over bid_top2, rounds {rounds}, rounds_g the plain twin's "
            f"exact count; span pair max_abs_err {err:.3e}")
        out[name] = {"k_local": k_local, "rounds": rounds, "span_err": err}
    xr = x[:MESH_ROUTER_ROWS]
    dense = "auction_phase_dense"
    calls = first_lap(lambda: anticluster(xr, k=MESH_K, mesh=mesh2,
                                          device=dev), dense, 1)
    k_local = MESH_K // 2
    shape = tuple(calls[0]["kw"]["cost"].shape)
    check(shape == (1, k_local, k_local),
          f"the mesh router request's first LAP has cost {shape}")
    what = f"the mesh router request's first LAP on shard 0 (n={k_local})"
    check_phase_calls(calls, what, ref.auction_phase_dense_ref, dense)
    check_rounds_g(calls, what, dense=True)
    out["router"] = {"k_local": k_local, "rounds": int(calls[0]["rounds"])}
    log(f"auction_phase_dense on {what}: all 4 phases in one launch bitwise "
        f"the every-round loop over top2, {out['router']['rounds']} rounds, "
        f"rounds_g the plain twin's exact count")
    return out


@contextlib.contextmanager
def telemetry_specs():
    """Within the block the data consumers build their engines with
    ``telemetry=True``, so that ``engine.last_telemetry`` holds each call's
    per-phase rounds (the sequencer's spec helper)."""
    inner = minibatch._auto_or_flat_spec
    minibatch._auto_or_flat_spec = \
        lambda *a, **kw: inner(*a, **kw).evolve(telemetry=True)
    try:
        yield
    finally:
        minibatch._auto_or_flat_spec = inner


def tele_rounds(engine) -> int:
    """The rounds the engine's last telemetry sums."""
    return int(engine.last_telemetry["rounds"].sum())


def batch_labels(batches, n: int) -> torch.Tensor:
    lab = np.zeros(n, np.int64)
    for b, idx in enumerate(batches):
        lab[idx] = b
    return torch.from_numpy(lab)


def sequencer_run(dev, n: int, card: str) -> dict:
    """(a): ``ABABatchSequencer(x, batch_size=512)`` on phase 3's rows (the
    stream route, ``"auction_fused"``), its cold partition, two warm
    epochs on drifted features, and ``grow`` by 1 %; each call's wall
    time, rounds, launches and the rounds its telemetry sums (equal to the
    kernels'); exact batch sizes, then floor/ceil; the same schedule from a
    second sequencer; the batches' diversity spread below random
    batches'."""
    d = PRESETS["diabetes"][1]
    x = make("mixture", n, d, seed=0)
    with telemetry_specs():
        seq, cold_s, used = session_call(ABABatchSequencer, x, SEQ_BATCH,
                                         device=dev)
    k, n_used = seq.k, seq.n_used
    laps = SEQ_BATCH - 1
    check((seq.result.route, seq.result.solver) == ("stream", "auction_fused")
          and used["bid_top2"] == laps and used["auction_phase"] == 4 * laps
          and used["gather_rows"] > 0 and used["plain_rounds"] == 0,
          f"(a) the sequencer's partition: {seq.result.route}/"
          f"{seq.result.solver}, launches {used}")
    check(isinstance(seq.batches, np.ndarray)
          and seq.batches.shape == (k, SEQ_BATCH),
          f"(a) batches of shape {np.shape(seq.batches)}")
    check(tele_rounds(seq.engine) == used["rounds"],
          f"(a) telemetry rounds {tele_rounds(seq.engine)} against the "
          f"kernels' {used['rounds']}")
    cold = seq.batches.copy()
    sd, spread = seq.diversity_stats()
    rand = minibatch.random_sequencer_batches(n_used, SEQ_BATCH)
    xr = torch.from_numpy(x[:n_used]).to(dev)
    div_r = diversity_per_cluster(xr, batch_labels(rand, n_used).to(dev),
                                  k).cpu().numpy()
    check(sd < float(div_r.std()) and spread < float(np.ptp(div_r)),
          f"(a) diversity sd {sd} / range {spread} not below random "
          f"{div_r.std()} / {np.ptp(div_r)}")
    run = {"k": k, "n_used": n_used, "cold_s": cold_s,
           "cold_rounds": used["rounds"], "cold_launches": used,
           "diversity_sd": sd, "diversity_range": spread,
           "random_sd": float(div_r.std()),
           "random_range": float(np.ptp(div_r)), "epochs": []}
    log(f"(a) ABABatchSequencer(batch_size={SEQ_BATCH}) on {card}: k={k} "
        f"n_used={n_used}, route {seq.result.route} / {seq.result.solver}, "
        f"partition {cold_s:.3f} s, {used['rounds']} rounds (the telemetry "
        f"sums {tele_rounds(seq.engine)}), bid_top2 {used['bid_top2']} "
        f"auction_phase {used['auction_phase']} gather_rows "
        f"{used['gather_rows']}; batches all {SEQ_BATCH}; diversity sd "
        f"{sd:.4e} range {spread:.4e} against random batches' "
        f"{div_r.std():.4e} / {np.ptp(div_r):.4e}")
    scale, seed = SEQ_DRIFT
    drift = (x + scale * np.random.default_rng(seed).standard_normal(
        x.shape)).astype(np.float32)
    for e in range(2):
        batches, warm_s, used = session_call(seq.epoch, 1, features=drift)
        check(used["auction_phase"] == 4 * laps
              and used["plain_rounds"] == 0
              and tele_rounds(seq.engine) == used["rounds"],
              f"(a) warm epoch {e + 1}: launches {used}, telemetry rounds "
              f"{tele_rounds(seq.engine)}")
        check(all(len(b) == SEQ_BATCH for b in batches)
              and [int(b[0]) for b in batches] == [
                  int(seq.batches[i][0]) for i in
                  minibatch.epoch_order(seq.seed, 1, k)],
              f"(a) warm epoch {e + 1}: batch sizes or order")
        skipped = seq.engine.last_telemetry["skipped"].mean(axis=(0, 2))
        run["epochs"].append({"seconds": warm_s, "rounds": used["rounds"],
                              "launches": used,
                              "skipped_share_by_phase": skipped.tolist()})
        log(f"  (a) warm epoch(1, features=x + {scale} N(0, 1)) "
            f"{e + 1}: {warm_s:.3f} s, {used['rounds']} rounds (the "
            f"telemetry sums {tele_rounds(seq.engine)}), auction_phase "
            f"{used['auction_phase']}, bid_top2 {used['bid_top2']}; share "
            f"of LAPs sitting out each phase {np.round(skipped, 3).tolist()}")
    check(seq.engine.compile_count == 1,
          f"(a) {seq.engine.compile_count} solve closures for one shape")
    added = make("mixture", SEQ_GROW, d, seed=1)
    res, grow_s, used = session_call(seq.grow, added)
    sizes = sorted({len(b) for b in seq.batches})
    grown = n_used + SEQ_GROW
    check(sizes[0] == grown // k and sizes[-1] == -(-grown // k)
          and seq.n_used == grown
          and used["auction_phase_dense"] == (1 if res.updated else 0),
          f"(a) grow: sizes {sizes}, n_used {seq.n_used}, {used}")
    run.update(grow_s=grow_s, grow_updated=bool(res.updated),
               grow_launches=used, grow_sizes=sizes)
    log(f"  (a) grow by {SEQ_GROW} rows: {grow_s:.3f} s, updated="
        f"{res.updated}, auction_phase_dense {used['auction_phase_dense']} "
        f"({used['rounds']} rounds), batch sizes {sizes}")
    again = ABABatchSequencer(x, SEQ_BATCH, device=dev)
    check(np.array_equal(again.batches, cold),
          "(a) a second sequencer gave another schedule")
    log("  (a) a second sequencer on the same rows: the same schedule, "
        "bitwise")
    return run


def folds_run(dev, n: int, card: str) -> dict:
    """(b): ``aba_folds(x, 10, categories=class)`` (the stream route with
    the solver kept ``"auction"``: one ``auction_phase_dense`` launch a
    LAP), constraint (5) exact, fold sizes within one, ``fold_splits``
    covering every row once; then ``fold_partition(x, 10)`` (the stream
    route, ``"auction_fused"``) and one update of 1 % of the rows."""
    d = PRESETS["diabetes"][1]
    x = make("mixture", n, d, seed=0)
    cls = attributes(n)["class"]
    laps = -(-n // FOLDS) - 1
    labels, fold_s, used = session_call(aba_folds, x, FOLDS,
                                        categories=cls, device=dev)
    check(used["auction_phase_dense"] == laps and used["gather_rows"] > 0
          and used["plain_rounds"] == 0 and used["auction_phase"] == 0,
          f"(b) aba_folds launches {used} for {laps} LAPs")
    check(stratified(labels, cls, FOLDS), "(b) constraint (5) broken")
    sizes = np.bincount(labels, minlength=FOLDS)
    check(sizes.max() - sizes.min() <= 1, f"(b) fold sizes {sizes}")
    seen = np.concatenate([val for _tr, val in fold_splits(labels, FOLDS)])
    check(np.array_equal(np.sort(seen), np.arange(n)),
          "(b) fold_splits does not cover every row once")
    launched = sum(used[name] for name in _build.launches)
    log(f"(b) aba_folds(x, {FOLDS}, categories=class) on {card}: stream "
        f"route, solver auction, {fold_s:.3f} s for {laps} LAPs "
        f"({fold_s / laps * 1e6:.1f} us a LAP, host-bound), "
        f"auction_phase_dense {used['auction_phase_dense']} gather_rows "
        f"{used['gather_rows']} ({launched / laps:.4f} of the port's "
        f"kernels a LAP), {used['rounds']} rounds; constraint (5) exact, "
        f"fold sizes {sizes.min()}..{sizes.max()}, fold_splits cover every "
        f"row once")
    part, live_s, live_used = session_call(fold_partition, x, FOLDS,
                                           device=dev)
    check((part.result.route, part.result.solver)
          == ("stream", "auction_fused")
          and live_used["auction_phase"] == 4 * laps
          and live_used["bid_top2"] == laps,
          f"(b) fold_partition {part.result.route}/{part.result.solver}: "
          f"{live_used}")
    m = n // 100
    removed = np.sort(np.random.default_rng(FOLD_DELTA_SEED).choice(
        n, m, replace=False))
    res, upd_s, upd_used = session_call(part.update,
                                        added=make("mixture", m, d, seed=1),
                                        removed=removed)
    balanced(part.labels, FOLDS)
    check(res.updated and upd_used["auction_phase_dense"] == 1,
          f"(b) the live folds' update: updated={res.updated} {upd_used}")
    log(f"  (b) fold_partition(x, {FOLDS}): {live_s:.3f} s "
        f"({live_s / laps * 1e6:.1f} us a LAP), bid_top2 "
        f"{live_used['bid_top2']} auction_phase {live_used['auction_phase']}"
        f"; update of {m} rows out and in: {upd_s:.3f} s, one "
        f"auction_phase_dense launch ({upd_used['rounds']} rounds), "
        f"balanced")
    return {"laps": laps, "folds_s": fold_s, "folds_launches": used,
            "live_s": live_s, "live_launches": live_used,
            "update_s": upd_s, "update_launches": upd_used}


def serve_burst(burst, dev, **kw) -> tuple:
    """The burst through a background router with ``telemetry=True``,
    admitted at once (``partition_many``): (results, seconds, counts,
    metrics, each lane's last call's rounds a LAP, summed over phases)."""
    router = AnticlusterRouter(k=ROUTER_K, plan=None, device=dev,
                               telemetry=True, **kw)
    try:
        out, seconds, used = session_call(router.partition_many, burst)
        lap_rounds = {key: lane.engine.last_telemetry["rounds"].sum(1)
                      for key, lane in router._lanes.items()}
        return out, seconds, used, router.metrics(), lap_rounds
    finally:
        router.close()


def router_run(dev, n: int, card: str) -> dict:
    """(c): a burst of ROUTER_BURST requests (rows drawn with a seed from
    ROUTER_ROWS, sliced from phase 3's data, k = 256) through the router
    stacked (``max_group=8``, row buckets) and one by one (``max_group=1,
    row_buckets=False``): every ticket balanced, its objective within 1e-3
    of the request's one-shot ``anticluster``, the bitwise ones counted;
    the metrics and throughput of both (``telemetry=True``: the stacked
    call's rounds a LAP, real rows against padding); then a live
    partition of 16 384
    rows with two updates of 1 %."""
    d = PRESETS["diabetes"][1]
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    rng = np.random.default_rng(ROUTER_SEED)
    rows = rng.integers(ROUTER_ROWS[0], ROUTER_ROWS[1] + 1, ROUTER_BURST)
    starts = rng.integers(0, n - ROUTER_ROWS[1], ROUTER_BURST)
    burst = [x[s:s + r] for s, r in zip(starts, rows)]
    oneshot, oneshot_s, used = session_call(
        lambda: [anticluster(b, k=ROUTER_K, plan=None, device=dev)
                 for b in burst])
    oneshot_rounds = used["rounds"]
    ofv = [float(objective_centroid(b, r.labels, ROUTER_K))
           for b, r in zip(burst, oneshot)]
    out = {"rows": [int(r) for r in rows], "oneshot_s": oneshot_s,
           "oneshot_rounds": oneshot_rounds}
    for name, kw in (("stacked", {"max_group": ROUTER_GROUP}),
                     ("one by one", {"max_group": 1,
                                     "row_buckets": False})):
        results, seconds, used, m, lap_rounds = serve_burst(burst, dev,
                                                           **kw)
        bitwise, worst = 0, 0.0
        for b, res, one, o in zip(burst, results, oneshot, ofv):
            balanced(res.labels, ROUTER_K)
            rel = (float(objective_centroid(b, res.labels, ROUTER_K)) - o) / o
            check(abs(rel) <= 1e-3, f"(c) {name}: objective {rel:+.2e} "
                  f"relative to the one-shot call's")
            worst = max(worst, abs(rel))
            bitwise += bool(torch.equal(res.labels, one.labels))
        check(used["auction_phase_dense"] > 0 and used["plain_rounds"] == 0,
              f"(c) {name}: launches {used}")
        run = {"seconds": seconds, "requests_per_s": ROUTER_BURST / seconds,
               "rounds": used["rounds"],
               "bitwise_oneshot": bitwise, "worst_rel_objective": worst,
               "launches": used, "stacked_calls": m.stacked_calls,
               "solo_calls": m.solo_calls, "warm_calls": m.warm_calls,
               "stack_occupancy": m.stack_occupancy,
               "row_occupancy": m.row_occupancy,
               "latency_p50": m.latency_p50, "latency_p99": m.latency_p99,
               "devices": m.devices}
        stacked = [r for key, r in lap_rounds.items() if key[0] == "stack"]
        if stacked:
            # the bucket's LAPs whose rows are real in every request, and
            # those that hold padding rows in some (all of them in the
            # shortest request's last ones)
            real_laps = int(rows.min()) // ROUTER_K - 1
            r = stacked[-1]
            run["lap_rounds_real"] = float(r[:real_laps].mean())
            run["lap_rounds_padded"] = float(r[real_laps:].mean())
            log(f"  (c) {name}: the last stacked call's rounds a LAP, "
                f"mean over LAPs 1..{real_laps} (every request's rows "
                f"real) {run['lap_rounds_real']:.1f}, over LAPs "
                f"{real_laps + 1}..{len(r)} (padding rows in some) "
                f"{run['lap_rounds_padded']:.1f}")
        out[name] = run
        log(f"(c) the router, {name} ({kw}) on {card}: {ROUTER_BURST} "
            f"requests in {seconds:.3f} s ({run['requests_per_s']:.2f} "
            f"requests/s; the one-shot calls {oneshot_s:.3f} s); stacked "
            f"calls {m.stacked_calls}, solo {m.solo_calls}, warm "
            f"{m.warm_calls}, stack occupancy {m.stack_occupancy:.3f}, row "
            f"occupancy {m.row_occupancy:.4f}, latency p50 "
            f"{m.latency_p50:.4f} s p99 {m.latency_p99:.4f} s; "
            f"auction_phase_dense {used['auction_phase_dense']}, "
            f"{used['rounds']} rounds (the one-shot calls {oneshot_rounds}); "
            f"every "
            f"ticket balanced, objective within {worst:.2e} of the one-shot "
            f"call's, {bitwise} of {ROUTER_BURST} labels bitwise")
    router = AnticlusterRouter(k=ROUTER_K, plan=None, device=dev)
    live = x[:LIVE_ROWS]
    m = LIVE_ROWS // 100
    times = []
    try:
        res, s, _ = session_call(
            lambda: router.open_partition("live", live).result(timeout=600))
        times.append(s)
        balanced(res.labels, ROUTER_K)
        for i in range(2):
            removed = np.sort(np.random.default_rng(i).choice(
                router.live_partition("live").n, m, replace=False))
            res, s, used = session_call(
                lambda: router.submit_update(
                    "live", added=x[LIVE_ROWS + i * m:LIVE_ROWS + (i + 1) * m],
                    removed=removed).result(timeout=600))
            balanced(res.labels, ROUTER_K)
            check(res.updated and used["auction_phase_dense"] == 1,
                  f"(c) live update {i + 1}: updated={res.updated} {used}")
            times.append(s)
        router.close_partition("live")
        check(router.metrics().live_partitions == 0, "(c) close_partition")
    finally:
        router.close()
    out["live_s"] = times
    log(f"  (c) a live partition of {LIVE_ROWS} rows: open "
        f"{times[0]:.3f} s, two updates of {m} rows out and in "
        f"{times[1]:.3f} / {times[2]:.3f} s (one auction_phase_dense launch "
        f"each, balanced), closed")
    return out


def observed_call(fn, *args, **kw):
    """``fn`` under tracing by :func:`session_call`: (output, seconds,
    counts, the trace's events)."""
    with obs.tracing() as trace:
        out, seconds, used = session_call(fn, *args, **kw)
    return out, seconds, used, trace.snapshot()


def repartition_span(events) -> dict:
    spans = [ev for ev in events if ev["name"] == "engine/repartition"]
    check(len(spans) == 1, f"{len(spans)} engine/repartition spans")
    return spans[0]["attrs"]


def observability_run(dev, n: int, card: str, default: dict,
                      stream: dict) -> dict:
    """(d): tracing on around an engine's flat call (phase 6's spec) and
    stream call (phase 3's), both with ``telemetry=True``: span and event
    names and counts, the ``engine/repartition`` span's ``rounds_total``
    equal to the kernels' rounds, the labels phase 6's and phase 3's; the
    flat call's middle LAPs profiled with telemetry on (no host read or
    wait in a LAP), and a one-shot flat call with tracing on (device
    launches a LAP equal to phase 6's window, tracing off);
    ``obs.memory_profile`` of the flat and the stream call."""
    d, k = PRESETS["diabetes"][1], 256
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    laps = -(-n // k) - 1
    out = {}
    for name, kw, digest, solver, field in (
            ("flat", {}, default["labels_sha256"], "auction",
             "solve_stats"),
            ("stream", {"chunk_size": "auto"}, stream["labels_sha256"],
             "auction_fused", "factored_stats")):
        eng = AnticlusterEngine(k=k, telemetry=True, device=dev, **kw)
        held = []
        window = lap_window(
            x, k, dev, solver, field, laps,
            f"(d) {name} partition with telemetry and tracing on",
            call=lambda: held.append(observed_call(eng.partition, x)))
        (res, _state), seconds, used, events = held[0]
        attrs = repartition_span(events)
        names = collections.Counter(ev["name"] for ev in events)
        check(digest_of(res.labels) == digest[:16],
              f"(d) {name}: labels with telemetry {digest_of(res.labels)} "
              f"against {digest[:16]} without")
        check(attrs["rounds_total"] == used["rounds"],
              f"(d) {name}: rounds_total {attrs['rounds_total']} against "
              f"the kernels' {used['rounds']}")
        check(names["solver/phase"] == 4
              and names.get("stream/plan", 0) == (name == "stream"),
              f"(d) {name}: events {dict(names)}")
        out[name] = {"seconds_profiled": seconds, "events": dict(names),
                     "rounds_total": attrs["rounds_total"],
                     "kernel_rounds": used["rounds"],
                     "warm_fraction": attrs["warm_fraction"],
                     "window": window}
        log(f"(d) {name} engine partition, telemetry and tracing on: spans "
            f"and events {dict(names)}; engine/repartition rounds_total "
            f"{attrs['rounds_total']} = the kernels' {used['rounds']}; "
            f"labels {digest_of(res.labels)}, those of the call without "
            f"telemetry")
    # the default call's middle LAPs profiled with tracing off, then on,
    # back to back (the process's first profiled window records more
    # events than later ones)
    windows, held = {}, []
    for traced in (False, True):
        windows[traced] = lap_window(
            x, k, dev, "auction", "solve", laps,
            f"(d) the default call with tracing {('off', 'on')[traced]}",
            call=(lambda: held.append(observed_call(anticluster, x, k=k,
                                                    device=dev)))
            if traced else None)
    names = collections.Counter(ev["name"] for ev in held[0][3])
    on, off = (windows[t]["device_launches_per_lap"] for t in (True, False))
    check(on == off and names == {"anticluster": 1},
          f"(d) tracing on: {on} device launches a LAP against {off} off; "
          f"events {dict(names)}")
    out["traced_oneshot"] = {"events": dict(names), "window_on": windows[True],
                             "window_off": windows[False]}
    log(f"  (d) the default call with tracing on: events {dict(names)}, "
        f"{on:.2f} device launches a LAP, with tracing off {off:.2f} "
        f"(phase 6: {default['window']['device_launches_per_lap']:.2f})")
    # each call with its statistics (the default) and without them
    # (stats=False: the solve's own footprint)
    for name, kw in (("flat", {}), ("stream", {"chunk_size": "auto"})):
        for stats in (True, False):
            prof = obs.memory_profile(anticluster, x, k=k, device=dev,
                                      stats=stats, **kw)
            check(prof.available and prof.temp_bytes > 0,
                  f"(d) memory_profile of the {name} call: {prof}")
            out[f"memory_{name}_stats_{stats}"] = dataclasses.asdict(prof)
            log(f"  (d) obs.memory_profile of the {name} call, stats="
                f"{stats}, on {card}: peak {prof.temp_bytes / 2**20:.2f} "
                f"MiB allocated on the card beyond what was live before, "
                f"arguments {prof.argument_bytes / 2**20:.2f} MiB, outputs "
                f"{prof.output_bytes / 2**20:.3f} MiB")
    return out


def consumers(dev, n: int, card: str, default: dict, stream: dict) -> dict:
    """Phase 10: the engine's consumers at full size on phase 3's rows."""
    return {"a": sequencer_run(dev, n, card), "b": folds_run(dev, n, card),
            "c": router_run(dev, n, card),
            "d": observability_run(dev, n, card, default, stream)}


# ---------------------------------------------------------------------------
# phase 11: the mesh route, the pipeline and the baselines
# ---------------------------------------------------------------------------

MESH_K = 256              # (a): k of the mesh calls, as phases 3 and 6
MESH_DRIFT = (0.01, 13)   # (a), (b): the drifted features' scale and seed
MESH_SEQ_BATCH = 480      # (a): k = 528 on the diabetes rows, even
MESH_FOLD_ROWS = 16384    # (a): the folds' rows (5 folds a shard)
MESH_ROUTER_ROWS = 16384  # (a): each router request's rows
PIPE_EPOCHS = 3           # (b)
PIPE_WIDTH = 8192         # (b): the training workload's two square layers
BASELINE_N = 16384        # (c): the Table-4 comparison's rows


def mesh_shards_one_by_one(x, k, shards, dev, **kw):
    """Each shard's rows solved alone (the per-shard call of the mesh
    route): (labels with the shard offsets, each shard's launches)."""
    n_local, k_local = x.shape[0] // shards, k // shards
    labels, used = [], []
    for s in range(shards):
        res, _s, u = user_call(x[s * n_local:(s + 1) * n_local], k_local,
                               dev, **kw)
        labels.append(res.labels + s * k_local)
        used.append(u)
    return torch.cat(labels), used


def mesh_run(dev, x, card: str, default: dict, stream: dict) -> dict:
    """(a): the mesh route on phase 3's rows at k = 256: a 1-shard mesh
    (bitwise phase 6's flat labels, and with ``chunk_size="auto"`` phase
    3's stream labels); a 2-shard mesh on the one card (k_local = 128,
    126 840 rows a shard, each shard streams), bitwise its shards solved
    one by one plus the offset, exact balance, locality, its launches equal
    the shards'; a mesh engine's ``partition`` and two warm
    ``repartition`` calls; the sequencer, the folds and a router lane with
    that mesh."""
    n = x.shape[0]
    k = MESH_K
    mesh1 = make_host_mesh(1, 1, device=dev)
    mesh2 = make_host_mesh(2, 1, device=dev)
    out = {}
    for name, kw, want, kernels in (
            ("flat", {}, default["labels_sha256"], ("auction_phase_dense",)),
            ("stream", {"chunk_size": "auto"}, stream["labels_sha256"],
             ("bid_top2", "auction_phase", "gather_rows"))):
        user_call(x, k, dev, mesh=mesh1, **kw)  # a first call
        res, seconds, used = user_call(x, k, dev, mesh=mesh1, **kw)
        digest = hashlib.sha256(res.labels.cpu().numpy().tobytes()).hexdigest()
        check(res.route == "mesh" and digest == want
              and all(used[kn] > 0 for kn in kernels)
              and used["plain_rounds"] == 0,
              f"(a) 1-shard mesh {name}: route {res.route}, sha256 "
              f"{digest[:16]} against {want[:16]}, launches {used}")
        out[f"one_shard_{name}"] = {"seconds": seconds, "launches": used,
                                    "labels_sha256": digest}
        log(f"(a) 1-shard mesh, {name} ({res.solver}) on {card}: "
            f"{seconds:.3f} s, labels bitwise phase "
            f"{6 if name == 'flat' else 3}'s (sha256 {digest[:16]}), "
            + " ".join(f"{kn} {used[kn]}" for kn in kernels))

    kw = {"chunk_size": "auto"}
    user_call(x, k, dev, mesh=mesh2, **kw)  # a first call
    res, seconds, used = user_call(x, k, dev, mesh=mesh2, **kw)
    parts, shard_used = mesh_shards_one_by_one(x, k, 2, dev, **kw)
    check(res.route == "mesh" and res.plan == (2, k // 2)
          and res.solver == "auction_fused"
          and torch.equal(res.labels, parts),
          f"(a) 2-shard mesh: route {res.route}, plan {res.plan}, "
          f"{res.solver}, labels not the shards' one by one")
    labels = res.labels.cpu().numpy()
    n_local = n // 2
    for s in range(2):
        seg = labels[s * n_local:(s + 1) * n_local]
        check(seg.min() >= s * k // 2 and seg.max() < (s + 1) * k // 2,
              f"(a) shard {s}'s labels {seg.min()}..{seg.max()}")
    balanced(res.labels, k)
    for name in ("bid_top2", "auction_phase", "gather_rows"):
        check(used[name] == sum(u[name] for u in shard_used) > 0,
              f"(a) 2-shard {name} {used[name]} against the shards' "
              f"{[u[name] for u in shard_used]}")
    q = quality(x, res.labels, k)
    out["two_shards"] = {
        "seconds": seconds, "launches": used,
        "launches_by_shard": shard_used, "ofv": q["ofv"],
        "labels_sha256": digest_of(res.labels)}
    log(f"(a) 2-shard mesh on one card (data axis 2, {n_local} rows and "
        f"k_local {k // 2} a shard, stream / auction_fused): {seconds:.3f} "
        f"s, labels bitwise the shards one by one plus the offset, shard s "
        f"in [{k // 2} s, {k // 2} (s + 1)), sizes {q['sizes']}, objective "
        f"{q['ofv']:.6e} (random {q['ofv_random']:.6e}); launches a shard "
        + "; ".join(f"bid_top2 {u['bid_top2']} auction_phase "
                    f"{u['auction_phase']} gather_rows {u['gather_rows']}"
                    for u in shard_used))

    scale, seed = MESH_DRIFT
    noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(dev)
    eng = AnticlusterEngine(k=k, mesh=mesh2, device=dev, **kw)
    (cold, state), cold_s, cold_used = session_call(eng.partition, x)
    check(isinstance(state, ShardedABAState)
          and torch.equal(cold.labels, res.labels)
          and tuple(state.prices[0].shape) == (2, 1, k // 2),
          "(a) the mesh engine's partition is not the one-shot's")
    epochs = []
    for e in (1, 2):
        xe = x + scale * e * noise
        (warm, state), warm_s, warm_used = session_call(eng.repartition,
                                                        xe, state)
        balanced(warm.labels, k)
        ofv = float(objective_centroid(xe, warm.labels, k))
        ofv_cold = float(objective_centroid(
            xe, anticluster(xe, k=k, mesh=mesh2, device=dev, **kw).labels,
            k))
        check(abs(ofv - ofv_cold) <= 0.01 * abs(ofv_cold),
              f"(a) warm repartition {e}: objective {ofv} against the cold "
              f"call's {ofv_cold}")
        epochs.append({"seconds": warm_s, "rounds": warm_used["rounds"],
                       "launches": warm_used, "ofv": ofv,
                       "ofv_cold": ofv_cold})
    check(eng.compile_count == 1, f"(a) {eng.compile_count} closures")
    out["engine"] = {"partition_s": cold_s, "rounds": cold_used["rounds"],
                     "epochs": epochs}
    log(f"(a) mesh engine (ShardedABAState, prices "
        f"{tuple(state.prices[0].shape)}): partition "
        f"{cold_s:.3f} s ({cold_used['rounds']} rounds), bitwise the "
        f"one-shot; warm repartitions on x + {scale} e N(0, 1): "
        + "; ".join(f"{ep['seconds']:.3f} s, {ep['rounds']} rounds, "
                    f"objective {ep['ofv']:.6e} (cold {ep['ofv_cold']:.6e})"
                    for ep in epochs))

    seq, seq_s, seq_used = session_call(ABABatchSequencer, x, MESH_SEQ_BATCH,
                                        mesh=mesh2, device=dev)
    check(seq.engine.spec.mesh is mesh2 and seq.result.route == "mesh"
          and seq.batches.shape == (seq.k, MESH_SEQ_BATCH),
          f"(a) the mesh sequencer: {seq.result.route}, batches "
          f"{np.shape(seq.batches)}")
    batches, seq_e_s, _ = session_call(seq.epoch, 1, features=x + scale
                                       * noise)
    check(all(len(b) == MESH_SEQ_BATCH for b in batches)
          and seq.engine.compile_count == 1,
          "(a) the mesh sequencer's warm epoch")
    xf = x[:MESH_FOLD_ROWS]
    folds, fold_s, fold_used = session_call(
        aba_folds, xf, 10, engine=fold_engine(10, mesh=mesh2, device=dev))
    check(balance_ok(folds, 10)
          and folds[:MESH_FOLD_ROWS // 2].max() < 5
          and folds[MESH_FOLD_ROWS // 2:].min() >= 5,
          "(a) the mesh folds: balance or locality")
    reqs = [x[i * MESH_ROUTER_ROWS:(i + 1) * MESH_ROUTER_ROWS]
            for i in range(4)]
    router = AnticlusterRouter(k=k, mesh=mesh2, device=dev,
                               background=False)
    try:
        served, router_s, router_used = session_call(router.partition_many,
                                                     reqs)
        metrics = router.metrics()
    finally:
        router.close()
    one = anticluster(reqs[0], k=k, mesh=mesh2, device=dev)
    check(torch.equal(served[0].labels, one.labels)
          and all(r.balanced and r.route == "mesh" for r in served)
          and metrics.solo_calls == 4 and metrics.stacked_calls == 0
          and metrics.warm_calls == 3,
          f"(a) the mesh router lane: {metrics}")
    out["consumers"] = {
        "sequencer_k": seq.k, "sequencer_partition_s": seq_s,
        "sequencer_launches": seq_used, "sequencer_epoch_s": seq_e_s,
        "folds_s": fold_s, "folds_launches": fold_used,
        "router_s": router_s, "router_launches": router_used}
    log(f"(a) with the 2-shard mesh: ABABatchSequencer(batch_size="
        f"{MESH_SEQ_BATCH}) k={seq.k} partition {seq_s:.3f} s, warm epoch "
        f"{seq_e_s:.3f} s; aba_folds(x[:{MESH_FOLD_ROWS}], 10) "
        f"{fold_s:.3f} s (5 folds a shard, {fold_used['auction_phase']} "
        f"auction_phase launches); a router lane served 4 requests of "
        f"{MESH_ROUTER_ROWS} rows one at a time in {router_s:.3f} s (the "
        f"first bitwise its one-shot, 3 warm)")
    return out


def train_workload(xd, w1, w2, batches):
    """A fixed device workload over an epoch's batches: per batch, the
    rows gathered on the card and two square layers, the loss read back
    (a training step's shape, without gradients)."""
    for idx in batches:
        h = torch.relu(xd[torch.from_numpy(idx).to(xd.device)] @ w1)
        float((h @ w2).square().mean())


def pipeline_run(dev, x, card: str) -> dict:
    """(b): ``ABAPipeline(x, batch_size=512)`` (k = 495, the stream route)
    for three epochs on drifted features, each consumed by a fixed device
    workload; labels and batch order bitwise an ``ABABatchSequencer``'s
    epoch by epoch; the time the dispatched solve had (the
    ``pipeline/epoch`` span), the ``pipeline/wait`` stall, and the overlap
    against the sequencer's synchronous epochs plus the workload alone."""
    scale, seed = MESH_DRIFT
    noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(dev)
    feats = [x + scale * e * noise for e in range(PIPE_EPOCHS)]
    gen = torch.Generator(device=dev).manual_seed(7)
    w1 = torch.randn((x.shape[1], PIPE_WIDTH), device=dev, generator=gen)
    w2 = torch.randn((PIPE_WIDTH, PIPE_WIDTH), device=dev,
                     generator=gen) / PIPE_WIDTH ** 0.5
    seq = ABABatchSequencer(x, SEQ_BATCH, device=dev)
    want, sync_s = [], []
    for e in range(PIPE_EPOCHS):
        batches, seconds, _ = session_call(
            seq.epoch, e, features=feats[e] if e else None)
        want.append((seq.result.labels.clone(), batches))
        if e:
            sync_s.append(seconds)
    train_workload(x, w1, w2, want[0][1])  # warm the workload's kernels
    _, work_s, _ = session_call(train_workload, x, w1, w2, want[0][1])
    pipe, build_s, _ = session_call(ABAPipeline, x, SEQ_BATCH, device=dev)
    check(pipe.overlapped and pipe.result.route == "stream",
          f"(b) the pipeline: overlapped {pipe.overlapped}, route "
          f"{pipe.result.route}")
    torch.cuda.synchronize()
    with obs.tracing() as tr:
        t0 = time.perf_counter()
        for e, ep in enumerate(pipe.epochs(PIPE_EPOCHS,
                                           features=lambda i: feats[i])):
            labels, batches = want[e]
            check(np.array_equal(pipe.labels, labels.cpu().numpy())
                  and all(np.array_equal(a, b) for a, b in zip(ep, batches)),
                  f"(b) epoch {e}: the pipeline's labels or batches are not "
                  "the sequencer's")
            train_workload(x, w1, w2, ep)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
    pipe.engine.close()
    spans = {name: [ev["dur"] for ev in tr.events if ev["name"] == name]
             for name in ("pipeline/epoch", "pipeline/wait")}
    overlap = PIPE_EPOCHS * work_s + sum(sync_s) - pipe_s
    check(pipe.engine.compile_count == 1
          and len(spans["pipeline/epoch"]) == PIPE_EPOCHS
          and len(spans["pipeline/wait"]) == PIPE_EPOCHS - 1,
          f"(b) spans {dict((k, len(v)) for k, v in spans.items())}")
    log(f"(b) ABAPipeline(batch_size={SEQ_BATCH}) on {card}: k={pipe.k}, "
        f"{PIPE_EPOCHS} epochs, labels and batches bitwise the sequencer's "
        f"each epoch; the workload alone {work_s:.3f} s an epoch, the "
        f"sequencer's warm epochs {[round(s, 3) for s in sync_s]} s; the "
        f"pipeline {pipe_s:.3f} s; the dispatched solves had (pipeline/"
        f"epoch) {[round(s, 3) for s in spans['pipeline/epoch']]} s and "
        f"stalled (pipeline/wait) {[round(s, 3) for s in spans['pipeline/wait']]}"
        f" s; overlap {overlap:.3f} s (the sequencer's solves plus the "
        f"workload, one after the other, less the pipeline)")
    return {"k": pipe.k, "build_s": build_s, "work_s": work_s,
            "sync_epoch_s": sync_s, "pipeline_s": pipe_s,
            "epoch_span_s": spans["pipeline/epoch"],
            "wait_span_s": spans["pipeline/wait"], "overlap_s": overlap}


def baselines_run(dev, x, card: str) -> dict:
    """(c): the paper's Table-4 comparison at n = 16 384, k = 256: ABA on
    the card beside ``fast_anticlustering`` (P-R5) and
    ``random_partition`` on the host; each one's objective on the card
    and its time."""
    k = MESH_K
    xb = x[:BASELINE_N]
    user_call(xb, k, dev)  # a first call
    res, aba_s, used = user_call(xb, k, dev)
    xh = xb.cpu().numpy()
    t0 = time.perf_counter()
    fast = baselines.fast_anticlustering(xh, k, seed=0)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rand = baselines.random_partition(BASELINE_N, k, seed=0)
    rand_s = time.perf_counter() - t0
    ofv = {name: float(objective_centroid(
        xb, torch.as_tensor(lab).to(dev).long(), k))
        for name, lab in (("aba", res.labels), ("fast_anticlustering", fast),
                          ("random_partition", rand))}
    for name, lab in (("fast_anticlustering", fast),
                      ("random_partition", rand)):
        check(balance_ok(np.asarray(lab), k), f"(c) {name} unbalanced")
    check(res.balanced and ofv["aba"] > ofv["random_partition"],
          f"(c) objectives {ofv}")
    log(f"(c) n={BASELINE_N} k={k}: ABA on {card} {aba_s * 1e3:.1f} ms "
        f"({used['auction_phase_dense']} auction_phase_dense launches), "
        f"objective {ofv['aba']:.6e}; fast_anticlustering (P-R5, host) "
        f"{fast_s:.3f} s, {ofv['fast_anticlustering']:.6e}; "
        f"random_partition (host) {rand_s * 1e3:.2f} ms, "
        f"{ofv['random_partition']:.6e}")
    return {"n": BASELINE_N, "k": k, "ofv": ofv,
            "seconds": {"aba": aba_s, "fast_anticlustering": fast_s,
                        "random_partition": rand_s},
            "aba_launches": used}


def mesh_pipeline_baselines(dev, n: int, card: str, default: dict,
                            stream: dict) -> dict:
    """Phase 11: the mesh route, the pipeline and the baselines."""
    t_start = time.perf_counter()
    d = PRESETS["diabetes"][1]
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
    out = {"a": mesh_run(dev, x, card, default, stream),
           "b": pipeline_run(dev, x, card), "c": baselines_run(dev, x, card)}
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 12: the model stack, falcon-mamba-7b serving
# ---------------------------------------------------------------------------

MODEL_ARCH = "falcon-mamba-7b"
MODEL_PARAMS = 7_272_665_088  # its ModelConfig, all 64 layers
MODEL_LAYERS = 64
PROMPTS = (2, 2048)  # B, S: the ssm_scan row's shape
DECODE_STEPS = 64
F32_STEPS = 16  # (c), (d): greedy steps compared, and steps sampled
SHORT_PROMPT = 256  # (e): the first decode step against forward
# The kernel path against the plain path at full width.  In bfloat16
# compute the two differ first by the scan's ~1e-6, which moves a bfloat16
# ulp of y here and there; over 64 layers the moves grow to the size of
# bfloat16's own rounding error (PERF.md, phase 12).  So a bfloat16 value
# is held within SPREAD_FACTOR times bfloat16's spread measured in the same
# run, the plain path's distance from the same prefill in float32 compute:
# each path lies within the spread of the float32 model, so within twice
# it of the other.  In float32 compute the two paths are held to the
# scan's own contract, F32_RTOL of the largest value.
SPREAD_FACTOR = 2.0
F32_RTOL = 1e-4


class StageClock:
    """Within the block ``transformer.prefill`` and ``decode_step``, as
    ``Generator`` calls them, are watched: the prefill timed between two
    synchronizes, with its ``ssm_scan`` launches; each decode step's
    launches counted, without a synchronize (the steps queue as they do
    unwatched)."""

    def __enter__(self):
        self.inner = (MT.prefill, MT.decode_step)
        self.decode_launches, self.steps = 0, 0

        def prefill(*args, **kw):
            torch.cuda.synchronize()
            n0, t0 = _build.launches["ssm_scan"], time.perf_counter()
            out = self.inner[0](*args, **kw)
            torch.cuda.synchronize()
            self.prefill_end = time.perf_counter()
            self.prefill_s = self.prefill_end - t0
            self.prefill_launches = _build.launches["ssm_scan"] - n0
            return out

        def decode_step(*args, **kw):
            n0 = _build.launches["ssm_scan"]
            out = self.inner[1](*args, **kw)
            self.decode_launches += _build.launches["ssm_scan"] - n0
            self.steps += 1
            return out

        MT.prefill, MT.decode_step = prefill, decode_step
        return self

    def __exit__(self, *exc):
        MT.prefill, MT.decode_step = self.inner


def greedy_margins(cfg, model, logits, cache, kv_len, steps):
    """Generator's greedy loop from a prefill's (logits, cache), with each
    token's top-2 margin: (tokens (B, steps), margins (B, steps))."""
    toks, margins = [], []
    for step in range(steps):
        top = logits[:, -1].topk(2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        toks.append(logits[:, -1:].argmax(-1))
        if step + 1 < steps:
            logits, cache = MT.decode_step(cfg, model, cache, kv_len + step,
                                           toks[-1])
    return (torch.cat(toks, 1).int().cpu().numpy(),
            torch.stack(margins, 1).cpu().numpy())


def first_steps(margins, tol, tokens, want) -> tuple:
    """Per row: the first step whose top-2 margin is under ``tol``, and the
    first step whose token differs from ``want``'s (the steps if none)."""
    steps = margins.shape[1]
    return ([int(np.argmax(m < tol)) if (m < tol).any() else steps
             for m in margins],
            [int(np.argmax(t != w)) if (t != w).any() else steps
             for t, w in zip(tokens, want)])


def layer_errors(h, want, norm: bool) -> list:
    """Each layer's ||h - want|| / ||want|| (``norm``), or max |h - want|
    over max |want|; h and want are (layers, B, di, ds)."""
    if norm:
        return ((h - want).flatten(1).norm(dim=1)
                / want.flatten(1).norm(dim=1)).tolist()
    return ((h - want).flatten(1).abs().amax(1)
            / want.flatten(1).abs().amax(1)).tolist()


def model_stack(dev, card: str) -> dict:
    """Phase 12: falcon-mamba-7b at full width and depth on the card."""
    t_start = time.perf_counter()
    cfg = model_registry.get_config(MODEL_ARCH)
    b, s = PROMPTS
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # (a) the parameters, drawn on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = MT.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    check(count == MODEL_PARAMS == MT.n_params(cfg)
          and cfg.n_layers == len(model.blocks) == MODEL_LAYERS
          and all(p.device.type == dev.type for p in model.parameters()),
          f"{MODEL_ARCH}: {count} parameters, {cfg.n_layers} layers")
    a = {"params": count, "bytes": nbytes, "init_s": init_s,
         "live_before_bytes": live,
         "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"(a) {MODEL_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, d_state {cfg.ssm.d_state}, vocab "
        f"{cfg.vocab_size}: {count} parameters ({nbytes / 2**30:.2f} GiB "
        f"{cfg.param_dtype}, compute {cfg.compute_dtype}) drawn on the card "
        f"in {init_s:.3f} s; max_memory_allocated "
        f"{a['max_memory_allocated'] / 2**30:.2f} GiB ({live / 2**20:.1f} "
        f"MiB live before)")

    # (b) Generator.generate as a user calls it
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, PROMPTS)
    max_len = s + DECODE_STEPS
    server = Generator(cfg, model, max_len=max_len, device=dev)
    server.generate(prompts, 2)  # warm-up at full size: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with StageClock() as clock:
        t0 = time.perf_counter()
        tokens = server.generate(prompts, DECODE_STEPS)
        t_end = time.perf_counter()
    used = counts()
    check(tokens.shape == (b, DECODE_STEPS)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"generate gave {tokens.shape} tokens or ones out of range")
    check(clock.prefill_launches == cfg.n_layers == used["ssm_scan"]
          and clock.decode_launches == 0
          and clock.steps == DECODE_STEPS - 1
          and not any(used[k] for k in _build.launches if k != "ssm_scan"),
          f"ssm_scan launched {clock.prefill_launches} times in the prefill "
          f"and {clock.decode_launches} in {clock.steps} decode steps; "
          f"all launches {used}")
    decode_s = t_end - clock.prefill_end
    bb = {"wall_s": t_end - t0, "prefill_s": clock.prefill_s,
          "prefill_tokens_per_s": b * s / clock.prefill_s,
          "decode_s": decode_s, "decode_steps": clock.steps,
          "decode_ms_per_step": decode_s / clock.steps * 1e3,
          "decode_tokens_per_s": b * clock.steps / decode_s,
          "ssm_scan_prefill": clock.prefill_launches,
          "ssm_scan_decode": clock.decode_launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated()}
    tp = torch.from_numpy(prompts).to(dev)
    prof = call_kernel_ms(None, None, dev, "ssm_scan",
                          call=lambda: MT.prefill(cfg, model, tp, max_len))
    bb["profiled_prefill"] = prof
    bb["idle_share"] = (1.0 - prof["device_ms"] / 1e3 / clock.prefill_s
                        if prof["device_ms"] else None)
    log(f"(b) Generator.generate(B={b}, S={s}, {DECODE_STEPS} greedy steps) "
        f"on {card}: {bb['wall_s']:.3f} s; prefill {clock.prefill_s:.4f} s "
        f"({bb['prefill_tokens_per_s']:.0f} tokens/s), ssm_scan launched "
        f"{clock.prefill_launches} times; {clock.steps} decode steps "
        f"{decode_s:.3f} s ({bb['decode_ms_per_step']:.2f} ms a step, "
        f"{bb['decode_tokens_per_s']:.1f} tokens/s), ssm_scan launched "
        f"{clock.decode_launches} times; peak "
        f"{bb['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"  a profiled prefill: device {prof['device_ms']:.2f} ms in "
        f"{prof['launches']} launches, ssm_scan {prof['kernel_ms']:.2f} ms "
        f"in {prof['kernel_launches']} (idle share {bb['idle_share']}); by "
        f"kernel: " + "; ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}"
                                for k, v in prof["kernels"].items()))

    # (c) the same prefill through the plain scan, in bfloat16 and float32
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    short = tp[:, :SHORT_PROMPT]
    logits_k, cache_k = MT.prefill(cfg, model, tp, max_len)
    logits_32, cache_32 = MT.prefill(cfg32, model, tp, max_len)
    one = call_kernel_ms(None, None, dev, "ssm_scan", call=lambda: (
        MT.decode_step(cfg, model, cache_k, s, logits_k.argmax(-1))))
    bb["profiled_decode_step"] = one
    bb["decode_idle_share"] = (1.0 - one["device_ms"]
                               / bb["decode_ms_per_step"]
                               if one["device_ms"] else None)
    log(f"  a profiled decode step: device {one['device_ms']:.2f} ms in "
        f"{one['launches']} launches against {bb['decode_ms_per_step']:.2f} "
        f"ms a step unprofiled (idle share {bb['decode_idle_share']}); by "
        f"kernel: " + "; ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}"
                                for k, v in one["kernels"].items()))
    reset_counts()
    with ops.forced_path("ref"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_p, cache_p = MT.prefill(cfg, model, tp, max_len)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_tokens, margins = greedy_margins(cfg, model, logits_p, cache_p,
                                               s, F32_STEPS)
        logits_p32, cache_p32 = MT.prefill(cfg32, model, short, max_len)
        plain_32, margins_32 = greedy_margins(cfg32, model, logits_p32,
                                              cache_p32, SHORT_PROMPT,
                                              F32_STEPS)
        inside = counts()
    logits_k32, cache_k32 = MT.prefill(cfg32, model, short, max_len)
    tokens_32, _ = greedy_margins(cfg32, model, logits_k32, cache_k32,
                                  SHORT_PROMPT, F32_STEPS)
    h_k, h_p, h_32 = (c["L0"]["h"] for c in (cache_k, cache_p, cache_32))
    h_err, h_spread = layer_errors(h_k, h_p, True), layer_errors(h_p, h_32,
                                                                 True)
    h_err32 = layer_errors(cache_k32["L0"]["h"], cache_p32["L0"]["h"], False)
    logit_err = (logits_k - logits_p).abs().max().item()
    logit_spread = (logits_p - logits_32).abs().max().item()
    logit_err32 = ((logits_k32 - logits_p32).abs().max()
                   / logits_p32.abs().max()).item()
    logit_tol = SPREAD_FACTOR * logit_spread
    # per row: the first step whose plain top-2 margin is under logit_tol,
    # and the first step whose tokens differ
    upto, same = first_steps(margins, logit_tol, tokens[:, :F32_STEPS],
                             plain_tokens)
    upto32, same32 = first_steps(margins_32, F32_RTOL * logits_p32.abs()
                                 .max().item(), tokens_32, plain_32)
    conv = [torch.equal(a, b) for a, b in zip(cache_k["L0"]["conv"],
                                              cache_p["L0"]["conv"])]
    ratio = [e / sp if sp else float(e > 0) * math.inf
             for e, sp in zip(h_err, h_spread)]
    worst = int(np.argmax(ratio))
    c = {"plain_prefill_s": plain_s, "launches": inside,
         "h_rel_err_by_layer": h_err, "h_bf16_spread_by_layer": h_spread,
         "h_ratio_by_layer": ratio,
         "h_rel_err_f32_by_layer": h_err32, "logits_max_abs_err": logit_err,
         "logits_bf16_spread": logit_spread,
         "logits_rel_err_f32": logit_err32,
         "logits_scale": logits_p.abs().max().item(),
         "conv_bitwise_layers": conv,
         "tokens_equal_steps": same, "first_small_margin_step": upto,
         "margins_min": margins.min(1).tolist(),
         "f32_tokens_equal_steps": same32,
         "f32_first_small_margin_step": upto32,
         "spread_factor": SPREAD_FACTOR, "f32_rtol": F32_RTOL}
    log(f"(c) the plain scan (forced_path('ref')): prefill {plain_s:.3f} s, "
        f"{sum(inside[k] for k in _build.launches)} kernel launches.  "
        f"bfloat16: the last layer's final h within {h_err[-1]:.3e} (norm) "
        f"of the plain path's, bfloat16's spread {h_spread[-1]:.3e} (largest "
        f"ratio {ratio[worst]:.3f}, layer {worst}; tolerance "
        f"{SPREAD_FACTOR}); last logits within {logit_err:.4e}, spread "
        f"{logit_spread:.4e} (max |logit| {c['logits_scale']:.3f}); conv "
        f"bitwise in the first {(conv + [False]).index(False)} layers; "
        f"greedy tokens equal for {same} steps of {F32_STEPS} by row, "
        f"the plain path's first top-2 margin under {logit_tol:.4f} at step "
        f"{upto} (smallest {c['margins_min']}).  float32: final h within "
        f"{max(h_err32):.3e} of max |h|, last logits within "
        f"{logit_err32:.3e} of max |logit| (tolerance {F32_RTOL}) at S="
        f"{SHORT_PROMPT}; greedy tokens equal for {same32} steps of "
        f"{F32_STEPS}, the first margin under the tolerance at step "
        f"{upto32}")
    check(not any(inside[k] for k in _build.launches),
          f"kernels launched under the forced plain path: {inside}")
    check(ratio[worst] <= SPREAD_FACTOR,
          f"bfloat16: final h of layer {worst} differs from the plain path "
          f"by {h_err[worst]:.3e}, over {SPREAD_FACTOR} x bfloat16's spread "
          f"{h_spread[worst]:.3e}")
    check(logit_err <= logit_tol, f"bfloat16: last logits differ from the "
          f"plain path by {logit_err} > {logit_tol}")
    check(conv[0], "the first layer's conv window differs from the plain "
          "path's (it precedes every scan)")
    check(all(sm >= u for sm, u in zip(same + same32, upto + upto32)),
          f"greedy tokens differ from the plain path's at steps {same} "
          f"(float32 {same32}), before the first steps {upto} ({upto32}) "
          f"whose top-2 margin is under the tolerance")
    check(max(h_err32) <= F32_RTOL and logit_err32 <= F32_RTOL,
          f"float32: final h within {max(h_err32)}, logits within "
          f"{logit_err32} of the plain path's > {F32_RTOL}")
    del logits_k, cache_k, logits_p, cache_p, logits_32, cache_32
    del logits_p32, cache_p32, logits_k32, cache_k32

    # (d) greedy is deterministic, sampling differs from it
    again = server.generate(prompts, F32_STEPS)
    sampled = server.generate(prompts, F32_STEPS, temperature=1.0, seed=1)
    check(np.array_equal(again, tokens[:, :F32_STEPS]),
          "greedy tokens differ between runs")
    check(bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all())
          and not np.array_equal(sampled, tokens[:, :F32_STEPS]),
          "temperature=1.0, seed=1: tokens out of range or equal to greedy")
    d = {"greedy_equal": True, "sampled_differs_steps": int(
        (sampled != tokens[:, :F32_STEPS]).any(0).sum())}
    log(f"(d) greedy twice: equal tokens; temperature=1.0 seed=1: tokens in "
        f"range, other than greedy at "
        f"{d['sampled_differs_steps']} of {F32_STEPS} steps")

    # (e) the first decode step against forward on the extended sequence
    lp, cache = MT.prefill(cfg, model, short, SHORT_PROMPT + 1)
    nxt = lp.argmax(-1)
    step, _ = MT.decode_step(cfg, model, cache, SHORT_PROMPT, nxt)
    ext = torch.cat([short, nxt], 1)
    full = MT.forward(cfg, model, ext)[:, -1]
    full32 = MT.forward(cfg32, model, ext)[:, -1]
    e_err = (step[:, 0] - full).abs().max().item()
    e_bf16 = (full - full32).abs().max().item()
    e = {"max_abs_err": e_err, "bf16_spread": e_bf16,
         "prefill_vs_forward": (lp[:, 0] - MT.forward(cfg, model, short)[
             :, -1]).abs().max().item()}
    log(f"(e) S={SHORT_PROMPT}: the first decode step's logits within "
        f"{e_err:.4e} of forward on the extended sequence (bfloat16's "
        f"spread, forward against float32 compute, {e_bf16:.4e}; tolerance "
        f"{SPREAD_FACTOR} x it); the prefill's last logits within "
        f"{e['prefill_vs_forward']:.4e} of forward's")
    check(e_err <= SPREAD_FACTOR * e_bf16, f"(e) the decode step's logits "
          f"differ from forward's by {e_err} > {SPREAD_FACTOR} x {e_bf16}")
    del model, server
    torch.cuda.empty_cache()
    return {"a": a, "b": bb, "c": c, "d": d, "e": e,
            "seconds": time.perf_counter() - t_start}


# ---------------------------------------------------------------------------
# phase 13: the model stack, the dense attention family serving
# ---------------------------------------------------------------------------

DENSE_ARCH = "gemma2-2b"
DENSE_PARAMS = 2_614_341_888   # its ModelConfig, all 26 layers
DENSE_PROMPTS = (2, 6144)      # B, S: past the local layers' 4 096 window
DENSE_STEPS = 64
DENSE_SAMPLED_STEPS = 16       # (e)
BIG_ARCH = "qwen2.5-14b"
BIG_PARAMS = 14_770_033_664    # its ModelConfig, all 48 layers
BIG_PROMPTS = (2, 2048)
BIG_STEPS = 16
FLASH_RTOL = 1e-4  # (c): flash_attention against full softmax, of max |out|


def full_softmax(q, k, v, *, window=0, softcap=0.0):
    """Attention through materialised, masked float32 scores (B, KV, G, S,
    S): flash_attention's plain yardstick."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / hd ** 0.5
    scores = ML._softcap(scores, softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(
        b, s, h, hd)


def draw_model(dev, arch: str, want: int, what: str, n_layers=None):
    """``init_params`` on the card from seed 0, with its count checked
    against ``want`` and ``n_params``: (cfg, model, log dict).  With
    ``n_layers`` the config's depth is cut to that many layers (whole
    blocks)."""
    cfg = model_registry.get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.empty_cache()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = MT.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    check(count == want == MT.n_params(cfg)
          and cfg.n_layers == len(model.blocks) * len(cfg.pattern)
          and all(p.device.type == dev.type for p in model.parameters()),
          f"{arch}: {count} parameters, {cfg.n_layers} layers")
    a = {"params": count, "bytes": nbytes, "init_s": init_s,
         "live_before_bytes": live,
         "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"({what}) {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, windows "
        f"{[sp.sliding_window for sp in cfg.pattern]}: {count} parameters "
        f"({nbytes / 2**30:.2f} GiB {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}) drawn on the card in {init_s:.3f} s; "
        f"max_memory_allocated {a['max_memory_allocated'] / 2**30:.2f} GiB "
        f"({live / 2**20:.1f} MiB live before)")
    return cfg, model, a


def serve_timed(cfg, model, dev, prompts, steps: int, card: str,
                what: str, scans: int = 0, front=None,
                max_len: int | None = None) -> tuple:
    """``Generator.generate`` as a user calls it, after one warm-up call:
    the prefill's wall and tokens/s, the decode steps' ms and tokens/s,
    ``scans`` launches of ``ssm_scan`` in the prefill (one a Mamba layer)
    and no other launch of the repo's kernels, none in decode, the peak
    memory; then a profiled prefill and a profiled decode step with their
    idle shares and device ms by kernel.  ``front`` holds the front end's
    inputs (``extra_embeds`` or ``enc_frames``) for every prefill;
    ``max_len`` defaults to the prompt and the steps.  Returns (server,
    tokens, log dict)."""
    b, s = prompts.shape
    front = front or {}
    max_len = max_len or s + steps
    server = Generator(cfg, model, max_len=max_len, device=dev)
    server.generate(prompts, 2, **front)  # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with StageClock() as clock:
        t0 = time.perf_counter()
        tokens = server.generate(prompts, steps, **front)
        t_end = time.perf_counter()
    used = counts()
    check(tokens.shape == (b, steps)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"generate gave {tokens.shape} tokens or ones out of range")
    check(clock.steps == steps - 1
          and clock.prefill_launches == scans and clock.decode_launches == 0
          and all(used[k] == (scans if k == "ssm_scan" else 0)
                  for k in _build.launches),
          f"{clock.steps} decode steps; ssm_scan launched "
          f"{clock.prefill_launches} times in the prefill (expected "
          f"{scans}) and {clock.decode_launches} in decode; the repo's "
          f"kernels launched {used}")
    decode_s = t_end - clock.prefill_end
    bb = {"wall_s": t_end - t0, "prefill_s": clock.prefill_s,
          "prefill_tokens_per_s": b * s / clock.prefill_s,
          "decode_s": decode_s, "decode_steps": clock.steps,
          "decode_ms_per_step": decode_s / clock.steps * 1e3,
          "decode_tokens_per_s": b * clock.steps / decode_s,
          "kernel_launches": {k: used[k] for k in _build.launches},
          "max_memory_allocated": torch.cuda.max_memory_allocated()}
    tp = torch.from_numpy(prompts).to(dev)
    prof = call_kernel_ms(None, None, dev, "ssm_scan", call=lambda: (
        MT.prefill(cfg, model, tp, max_len, **front)))
    logits, cache = MT.prefill(cfg, model, tp, max_len, **front)
    one = call_kernel_ms(None, None, dev, "ssm_scan", call=lambda: (
        MT.decode_step(cfg, model, cache, s, logits.argmax(-1))))
    del logits, cache
    bb["profiled_prefill"], bb["profiled_decode_step"] = prof, one
    bb["idle_share"] = (1.0 - prof["device_ms"] / 1e3 / clock.prefill_s
                        if prof["device_ms"] else None)
    bb["decode_idle_share"] = (1.0 - one["device_ms"]
                               / bb["decode_ms_per_step"]
                               if one["device_ms"] else None)
    log(f"({what}) Generator.generate(B={b}, S={s}, {steps} greedy steps) on "
        f"{card}: {bb['wall_s']:.3f} s; prefill {clock.prefill_s:.4f} s "
        f"({bb['prefill_tokens_per_s']:.0f} tokens/s); {clock.steps} decode "
        f"steps {decode_s:.3f} s ({bb['decode_ms_per_step']:.2f} ms a step, "
        f"{bb['decode_tokens_per_s']:.1f} tokens/s); launches of the repo's "
        f"kernels {sum(bb['kernel_launches'].values())}; peak "
        f"{bb['max_memory_allocated'] / 2**30:.2f} GiB")
    for name, run, share in (("prefill", prof, bb["idle_share"]),
                             ("decode step", one, bb["decode_idle_share"])):
        log(f"  a profiled {name}: device {run['device_ms']:.2f} ms in "
            f"{run['launches']} launches (idle share {share}); by kernel: "
            + "; ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}"
                        for k, v in run["kernels"].items()))
    return server, tokens, bb


def last_logits(cfg, model, tokens, **kw):
    """``forward``'s logits at the last position only: (B, 1, V)."""
    return MT.logits_from_hidden(cfg, model, MT.forward_hidden(
        cfg, model, tokens, **kw)[:, -1:])


def decode_against_forward(cfg, model, tp, what: str, front=None,
                           positions=None) -> dict:
    """The first decode step after the prefill of ``tp`` against
    ``forward`` on the extended sequence, and the prefill's last logits
    against ``forward``'s, each within SPREAD_FACTOR times bfloat16's own
    spread: ``forward`` in bfloat16 against float32 compute on the
    extended sequence, in this run.  ``front`` (``extra_embeds`` or
    ``enc_frames``) goes to every call; with ``positions`` (B, S) or (B,
    S, 3) the new token sits one past the last position in every
    stream."""
    front = front or {}
    s = tp.shape[1]
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    lp, cache = MT.prefill(cfg, model, tp, s + 1, positions=positions,
                           **front)
    nxt = lp.argmax(-1)
    step_pos = None if positions is None else positions[:, -1:] + 1
    step, _ = MT.decode_step(cfg, model, cache, s, nxt, positions=step_pos)
    del cache
    ext = torch.cat([tp, nxt], 1)
    kw = dict(front, positions=None if positions is None
              else torch.cat([positions, step_pos], 1))
    full = last_logits(cfg, model, ext, **kw)
    full32 = last_logits(cfg32, model, ext, **kw)
    d = {"max_abs_err": (step - full).abs().max().item(),
         "bf16_spread": (full - full32).abs().max().item(),
         "prefill_vs_forward": (lp - last_logits(
             cfg, model, tp, positions=positions, **front)).abs().max()
         .item(),
         "logits_scale": full32[..., :cfg.vocab_size].abs().max().item(),
         "spread_factor": SPREAD_FACTOR}
    tol = SPREAD_FACTOR * d["bf16_spread"]
    log(f"({what}) S={s}: the first decode step's logits within "
        f"{d['max_abs_err']:.4e} of forward on the extended sequence "
        f"(bfloat16's spread, forward against float32 compute, "
        f"{d['bf16_spread']:.4e}; tolerance {SPREAD_FACTOR} x it; max "
        f"|logit| {d['logits_scale']:.3f}); the prefill's last logits "
        f"within {d['prefill_vs_forward']:.4e} of forward's")
    check(d["max_abs_err"] <= tol and d["prefill_vs_forward"] <= tol,
          f"({what}) the decode step's logits differ from forward's by "
          f"{d['max_abs_err']}, the prefill's by {d['prefill_vs_forward']}; "
          f"tolerance {tol}")
    return d


def flash_against_full(cfg, model, tp) -> dict:
    """(c): ``flash_attention`` on layer 0's q, k and v (the first local
    layer's, float32 compute) against ``full_softmax``, windowed and
    global, with the softcap; within FLASH_RTOL of max |out|; each timed."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    layer = model.blocks[0]["L0"]
    h = MT._norm(cfg32, layer, "ln1", MT.embed_tokens(cfg32, model, tp))
    q, k, v = ML.attn_qkv(cfg32, layer.attn, h,
                          MT._positions_default(cfg, tp))
    del h
    out, got = {}, {}
    for name, window in (("windowed", layer.spec.sliding_window),
                         ("global", 0)):
        kw = dict(window=window, softcap=cfg.attn_softcap)
        got[name] = ML.flash_attention(q, k, v, chunk_q=cfg.attn_chunk_q,
                                       chunk_kv=cfg.attn_chunk_kv, **kw)
        want = full_softmax(q, k, v, **kw)
        err = (got[name] - want).abs().max().item()
        scale = want.abs().max().item()
        del want
        out[name] = {"window": window, "max_abs_err": err, "scale": scale,
                     "flash_ms": time_ms(lambda: ML.flash_attention(
                         q, k, v, chunk_q=cfg.attn_chunk_q,
                         chunk_kv=cfg.attn_chunk_kv, **kw), 3, 1),
                     "full_ms": time_ms(lambda: full_softmax(q, k, v, **kw),
                                        3, 1)}
    # the rows past the window, where it binds: the two outputs differ
    w = layer.spec.sliding_window
    out["window_moves"] = (got["windowed"][:, w:] - got["global"][:, w:]
                           ).abs().max().item()
    del got
    log(f"(c) flash_attention on layer 0's q {tuple(q.shape)}, k, v "
        f"{tuple(k.shape)} in float32, softcap {cfg.attn_softcap}, chunks "
        f"{cfg.attn_chunk_q} / {cfg.attn_chunk_kv}, against full softmax: "
        + "; ".join(f"{n} (window {r['window']}) within {r['max_abs_err']:.3e}"
                    f" of max |out| {r['scale']:.4f}, {r['flash_ms']:.2f} ms "
                    f"against {r['full_ms']:.2f} ms"
                    for n, r in out.items() if n != "window_moves")
        + f"; tolerance {FLASH_RTOL}; past position {w} the windowed output "
        f"differs from the global one by up to {out['window_moves']:.4f}")
    for n in ("windowed", "global"):
        r = out[n]
        check(r["max_abs_err"] <= FLASH_RTOL * r["scale"],
              f"(c) flash_attention {n}: {r['max_abs_err']} > {FLASH_RTOL} "
              f"x {r['scale']}")
    check(out["window_moves"] > FLASH_RTOL * out["global"]["scale"],
          f"(c) the window of {w} changes no output past position {w}")
    return out


def greedy_and_sampled(cfg, server, prompts, tokens, steps: int) -> dict:
    """(e): ``steps`` greedy steps again equal to ``tokens``' first, and
    ``steps`` sampled ones (temperature 1.0, seed 1) in range and other
    than greedy."""
    again = server.generate(prompts, steps)
    sampled = server.generate(prompts, steps, temperature=1.0, seed=1)
    greedy = tokens[:, :steps]
    check(np.array_equal(again, greedy), "greedy tokens differ between runs")
    check(bool(((sampled >= 0) & (sampled < cfg.vocab_size)).all())
          and not np.array_equal(sampled, greedy),
          "temperature=1.0, seed=1: tokens out of range or equal to greedy")
    e = {"greedy_equal": True,
         "sampled_differs_steps": int((sampled != greedy).any(0).sum())}
    log(f"(e) greedy twice: equal tokens; temperature=1.0 seed=1: tokens in "
        f"range, other than greedy at {e['sampled_differs_steps']} of "
        f"{steps} steps")
    return e


def dense_stack(dev, card: str) -> dict:
    """Phase 13: gemma2-2b, then qwen2.5-14b, at full width and depth."""
    t_start = time.perf_counter()
    out = {"live_at_start_bytes": torch.cuda.memory_allocated()}
    cfg, model, out["a"] = draw_model(dev, DENSE_ARCH, DENSE_PARAMS, "a")
    prompts = np.random.default_rng(13).integers(0, cfg.vocab_size,
                                                 DENSE_PROMPTS)
    server, tokens, out["b"] = serve_timed(cfg, model, dev, prompts,
                                           DENSE_STEPS, card, "b")
    tp = torch.from_numpy(prompts).to(dev)
    out["c"] = flash_against_full(cfg, model, tp)
    out["d"] = decode_against_forward(cfg, model, tp, "d")
    out["e"] = greedy_and_sampled(cfg, server, prompts, tokens,
                                  DENSE_SAMPLED_STEPS)
    del model, server, tp
    torch.cuda.empty_cache()
    out["gemma2_s"] = time.perf_counter() - t_start

    cfg, model, f = draw_model(dev, BIG_ARCH, BIG_PARAMS, "f")
    prompts = np.random.default_rng(14).integers(0, cfg.vocab_size,
                                                 BIG_PROMPTS)
    server, _, f["b"] = serve_timed(cfg, model, dev, prompts, BIG_STEPS, card,
                                    "f")
    f["d"] = decode_against_forward(cfg, model,
                                    torch.from_numpy(prompts).to(dev), "f")
    out["f"] = f
    del model, server
    torch.cuda.empty_cache()
    out["live_at_end_bytes"] = torch.cuda.memory_allocated()
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 14: the model stack, the MoE and MLA family and the hybrid serving
# ---------------------------------------------------------------------------

# (arch, layers on the card (None: all of its ModelConfig's), their
# parameters, the full config's, greedy steps of (b)).  deepseek-v2-236b
# (891.7 GiB in float32) keeps 3 of its 60 layers and jamba-v0.1-52b
# (192.1 GiB) one of its 4 blocks of 8 layers: one card holds no more.
MOE_MODELS = (
    ("granite-moe-3b-a800m", None, 3_903_186_432, 3_903_186_432, 32),
    ("deepseek-v2-236b", 3, 12_964_930_560, 239_375_569_920, 16),
    ("jamba-v0.1-52b", 8, 13_295_235_072, 51_570_315_264, 16),
)
MOE_PROMPTS = (2, 2048)
MOE_SAMPLED_STEPS = 16  # (e)
# (d) runs on the prompts' first CHECK_PROMPT tokens, at the capacity
# factor that drops nothing (C = T + 1): there deepseek's float32 forward
# over 2 x 2 049 tokens would hold (160, 4 104, 5 120) float32 expert
# blocks of 13.4 GB beside its 52 GB of weights
CHECK_PROMPT = 1024
MOE_RTOL = 1e-4  # (c), (f): float32, of max |out|


def moe_modules(model) -> list:
    return [m for m in model.modules() if isinstance(m, MOE.MoE)]


@contextlib.contextmanager
def capacity_factor(model, cf: float):
    """Within the block every MoE layer of ``model`` routes with capacity
    factor ``cf`` (its config swapped, then restored)."""
    mods = moe_modules(model)
    kept = [m.cfg for m in mods]
    for m in mods:
        m.cfg = dataclasses.replace(m.cfg, moe=dataclasses.replace(
            m.cfg.moe, capacity_factor=cf))
    try:
        yield
    finally:
        for m, c in zip(mods, kept):
            m.cfg = c


def prefill_drops(cfg, model, tp, max_len: int) -> dict:
    """The (token, choice) pairs that each MoE layer of a prefill drops at
    the config's capacity factor, from ``moe.route`` on the layer's input
    (a forward hook).  The reference's own rule, so reported, not
    checked."""
    dropped, pairs = [], []

    def hook(mod, args, out):
        r = MOE.route(mod.cfg, mod.router, args[0].reshape(
            -1, args[0].shape[-1]))
        dropped.append((~r.keep).sum())
        pairs.append(r.keep.numel())

    handles = [m.register_forward_hook(hook) for m in moe_modules(model)]
    try:
        MT.prefill(cfg, model, tp, max_len)
    finally:
        for h in handles:
            h.remove()
    by_layer = [int(d) for d in dropped]
    out = {"capacity_factor": cfg.moe.capacity_factor,
           "moe_layers": len(by_layer), "pairs_a_layer": pairs[0],
           "dropped": sum(by_layer), "dropped_by_layer": by_layer,
           "dropped_share": sum(by_layer) / sum(pairs)}
    log(f"(b) the prefill's MoE layers at capacity factor "
        f"{out['capacity_factor']}: {out['dropped']} of {sum(pairs)} (token, "
        f"choice) pairs dropped ({out['dropped_share']:.4%}) over "
        f"{len(by_layer)} layers, by layer {by_layer}")
    return out


def expert_loop(cfg, p, x):
    """The MoE layer ``p`` as a plain loop over the experts: each expert's
    gated FFN on the tokens of the first ``cap`` pairs (token-major) that
    chose it, weighted by ``top_p`` and added at their tokens, then the
    shared experts.  Returns (out, the kept pairs)."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    r = MOE.route(cfg, p.router, xf)
    act = MOE._act(cfg)
    flat_e, w = r.top_e.reshape(-1), r.top_p.reshape(-1)
    out = torch.zeros_like(xf)
    kept = torch.zeros_like(r.keep)
    for e in range(m.n_experts):
        pairs = torch.nonzero(flat_e == e)[:r.cap, 0]
        kept[pairs] = True
        tok = pairs // m.top_k
        he = xf[tok]
        y = (act(he @ p.wg[e]) * (he @ p.wi[e])) @ p.wo[e]
        out.index_add_(0, tok, y * w[pairs, None])
    if m.n_shared:
        out += (act(xf @ p.shared_wg) * (xf @ p.shared_wi)) @ p.shared_wo
    return out.reshape(x.shape), kept


def moe_against_loop(cfg, model, tp) -> dict:
    """(c): the first MoE layer in float32 on the prompts' normed
    embeddings against :func:`expert_loop`: the same kept pairs, the
    output within MOE_RTOL of max |out|; each timed."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    layer = next(lay for blk in model.blocks for lay in blk.values()
                 if lay.spec.mlp == "moe")
    x = MT._norm(cfg32, layer, "ln2", MT.embed_tokens(cfg32, model, tp))
    got = layer.mlp(x)
    want, kept = expert_loop(layer.mlp.cfg, layer.mlp, x)
    r = MOE.route(layer.mlp.cfg, layer.mlp.router, x.reshape(-1, x.shape[-1]))
    c = {"tokens": r.top_e.shape[0], "experts": cfg.moe.n_experts,
         "top_k": cfg.moe.top_k, "capacity": r.cap,
         "n_shared": cfg.moe.n_shared,
         "kept_pairs": int(r.keep.sum()), "pairs": r.keep.numel(),
         "same_kept_pairs": bool(torch.equal(kept, r.keep)),
         "max_abs_err": (got - want).abs().max().item(),
         "scale": want.abs().max().item(),
         "moe_ms": time_ms(lambda: layer.mlp(x), 3, 1),
         "loop_ms": time_ms(lambda: expert_loop(layer.mlp.cfg, layer.mlp, x),
                            3, 1)}
    del got, want, x
    log(f"(c) one MoE layer in float32 ({c['tokens']} tokens, "
        f"{c['experts']} experts, top {c['top_k']}, capacity {c['capacity']}, "
        f"{c['n_shared']} shared): {c['kept_pairs']} of {c['pairs']} pairs "
        f"kept, the loop's the same: {c['same_kept_pairs']}; within "
        f"{c['max_abs_err']:.3e} of the per-expert loop (max |out| "
        f"{c['scale']:.4f}; tolerance {MOE_RTOL} of it); {c['moe_ms']:.2f} "
        f"ms against the loop's {c['loop_ms']:.2f} ms")
    check(c["same_kept_pairs"]
          and c["max_abs_err"] <= MOE_RTOL * c["scale"],
          f"(c) the MoE layer against the per-expert loop: {c}")
    return c


def mla_against_expanded(cfg, model, tp) -> dict:
    """(f): layer 0's MLA in float32 on the prompts' normed embeddings: the
    absorbed decode of the last token over the latent cache of the others
    against the expanded form's last row over the whole sequence, within
    MOE_RTOL of max |out|; each timed.  And the cache's size: ``kv_lora +
    qk_rope`` values a token and a layer against a dense cache's 2 H
    head_dim."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    layer = model.blocks[0]["L0"]
    x = MT._norm(cfg32, layer, "ln1", MT.embed_tokens(cfg32, model, tp))
    pos = MT._positions_default(cfg, tp)
    b, s = tp.shape
    full, _ = layer.attn(x, pos)
    _, (ckv, kr) = layer.attn(x[:, :-1], pos[:, :-1])
    cache = (torch.zeros(b, s, ckv.shape[-1], device=x.device),
             torch.zeros(b, s, kr.shape[-1], device=x.device))
    cache[0][:, :s - 1], cache[1][:, :s - 1] = ckv, kr
    step, _ = layer.attn(x[:, -1:], pos[:, -1:], cache=cache, kv_len=s - 1)
    m = cfg.mla
    f = {"seq": s, "max_abs_err": (step[:, 0] - full[:, -1]).abs().max()
         .item(), "scale": full[:, -1].abs().max().item(),
         "expanded_ms": time_ms(lambda: layer.attn(x, pos), 3, 1),
         "absorbed_ms": time_ms(lambda: layer.attn(
             x[:, -1:], pos[:, -1:], cache=cache, kv_len=s - 1), 3, 1),
         "cache_values_a_token_a_layer": m.kv_lora + m.qk_rope_dim,
         "dense_values_a_token_a_layer": 2 * cfg.n_heads * cfg.head_dim}
    del full, x
    log(f"(f) layer 0's MLA in float32 at S = {s}: the absorbed decode of "
        f"the last token within {f['max_abs_err']:.3e} of the expanded "
        f"form's last row (max |out| {f['scale']:.4f}; tolerance {MOE_RTOL} "
        f"of it); expanded over {s} tokens {f['expanded_ms']:.2f} ms, one "
        f"absorbed step {f['absorbed_ms']:.3f} ms; the cache holds "
        f"{f['cache_values_a_token_a_layer']} values a token and a layer "
        f"against {f['dense_values_a_token_a_layer']} for a dense k, v cache")
    check(f["max_abs_err"] <= MOE_RTOL * f["scale"],
          f"(f) the absorbed decode against the expanded form: {f}")
    return f


MESH_PREFILL_ARCH = "deepseek-v2-236b"  # (g): the config with shared experts
MODEL_MESH = (1, 4)  # (g), phase 17 (b): make_host_mesh(1, 4) of the one card
MESH_TURNS = ("mesh", "none", "none", "mesh")  # (g), phase 17 (b): timed


def first_moe_against_mesh(cfg, model, tokens, mesh, what: str) -> dict:
    """The first MoE layer in float32 on the normed embeddings of
    ``tokens``, through ``mesh``'s ``model`` axis against ``mesh=None``:
    within MOE_RTOL of max |out|, each timed."""
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    layer = next(lay for blk in model.blocks for lay in blk.values()
                 if lay.spec.mlp == "moe")
    with torch.no_grad():
        x = MT._norm(cfg32, layer, "ln2", MT.embed_tokens(cfg32, model,
                                                          tokens))
        want = MOE.moe_ref(cfg32, layer.mlp, x)
        got = MT._moe_call(cfg32, layer.mlp, x, mesh)
        c = {"max_abs_err": (got - want).abs().max().item(),
             "scale": want.abs().max().item(),
             "mesh_ms": time_ms(lambda: MT._moe_call(cfg32, layer.mlp, x,
                                                     mesh), 3, 1),
             "none_ms": time_ms(lambda: MOE.moe_ref(cfg32, layer.mlp, x),
                                3, 1)}
    del x, got, want
    log(f"({what}) the first MoE layer in float32 through the {mesh.shape} "
        f"mesh: within {c['max_abs_err']:.3e} of mesh=None (max |out| "
        f"{c['scale']:.4f}; tolerance {MOE_RTOL} of it); {c['mesh_ms']:.2f} "
        f"ms against {c['none_ms']:.2f} ms")
    check(c["max_abs_err"] <= MOE_RTOL * c["scale"],
          f"({what}) the MoE layer through the mesh: {c}")
    return c


def mesh_prefill(cfg, model, tp) -> dict:
    """(g): deepseek-v2-236b through a MODEL_MESH mesh of the one card:
    the first MoE layer in float32 against ``mesh=None``; one prefill of
    the prompts against its own without the mesh, the last logits within
    SPREAD_FACTOR times bfloat16's spread (the prefill's distance from the
    float32-compute prefill), each timed."""
    mesh = make_host_mesh(*MODEL_MESH, device="cuda")
    g = {"layer": first_moe_against_mesh(cfg, model, tp, mesh, "g")}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    max_len = tp.shape[1]
    meshes = {"mesh": mesh, "none": None}
    logits, walls = {}, {"mesh": [], "none": []}
    with torch.no_grad():
        for name in ("mesh", "none") + MESH_TURNS:  # a warm-up each first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[name] = MT.prefill(cfg, model, tp, max_len,
                                      mesh=meshes[name])[0]
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        logits["float32"] = MT.prefill(cfg32, model, tp, max_len)[0]
    err = (logits["mesh"] - logits["none"]).abs().max().item()
    spread = (logits["none"] - logits["float32"]).abs().max().item()
    g |= {"logit_err": err, "logit_spread": spread,
          "prefill_s": {k: v[1:] for k, v in walls.items()}}
    log(f"(g) prefills of {tuple(tp.shape)} tokens in turns after a warm-up "
        f"each: through the mesh {', '.join(f'{w:.4f}' for w in walls['mesh'][1:])}"
        f" s, without {', '.join(f'{w:.4f}' for w in walls['none'][1:])} s; "
        f"the last logits within {err:.4e} of its own (bfloat16's spread "
        f"{spread:.4e}, tolerance {SPREAD_FACTOR} x)")
    check(math.isfinite(err) and err <= SPREAD_FACTOR * spread,
          f"(g) the prefill through the mesh: {err} against spread {spread}")
    return g


def moe_stack(dev, card: str) -> dict:
    """Phase 14: granite-moe-3b at full depth, deepseek-v2-236b at 3 of
    its 60 layers and jamba-v0.1-52b at one block of 8, at full width."""
    t_start = time.perf_counter()
    out = {"live_at_start_bytes": torch.cuda.memory_allocated()}
    for i, (arch, layers, want, full, steps) in enumerate(MOE_MODELS):
        t0 = time.perf_counter()
        cfg, model, run = draw_model(dev, arch, want, "a", n_layers=layers)
        full_layers = model_registry.get_config(arch).n_layers
        run |= {"layers": cfg.n_layers, "full_layers": full_layers,
                "full_params": full}
        log(f"  depth {cfg.n_layers} of {full_layers} layers (the full "
            f"config: {full} parameters); experts {cfg.moe.n_experts} (padded "
            f"{MOE.padded_experts(cfg)}), top {cfg.moe.top_k}, shared "
            f"{cfg.moe.n_shared}, capacity factor {cfg.moe.capacity_factor}; "
            f"mixers {[sp.mixer for sp in cfg.pattern]}")
        prompts = np.random.default_rng(15 + i).integers(0, cfg.vocab_size,
                                                         MOE_PROMPTS)
        scans = sum(sp.mixer == "mamba" for sp in cfg.pattern) * cfg.n_blocks
        server, tokens, run["b"] = serve_timed(cfg, model, dev, prompts,
                                               steps, card, "b", scans=scans)
        tp = torch.from_numpy(prompts).to(dev)
        run["b"]["drops"] = prefill_drops(cfg, model, tp,
                                          MOE_PROMPTS[1] + steps)
        run["c"] = moe_against_loop(cfg, model, tp)
        if cfg.mla:
            run["f"] = mla_against_expanded(cfg, model, tp)
        no_drop = MOE.padded_experts(cfg) / cfg.moe.top_k
        with capacity_factor(model, no_drop):
            run["d"] = decode_against_forward(cfg, model,
                                              tp[:, :CHECK_PROMPT], "d")
        run["d"]["capacity_factor"] = no_drop
        run["e"] = greedy_and_sampled(cfg, server, prompts, tokens,
                                      MOE_SAMPLED_STEPS)
        del server
        torch.cuda.empty_cache()
        if arch == MESH_PREFILL_ARCH:
            run["g"] = mesh_prefill(cfg, model, tp)
        del model, tp
        torch.cuda.empty_cache()
        run["seconds"] = time.perf_counter() - t0
        out[arch] = run
    out["live_at_end_bytes"] = torch.cuda.memory_allocated()
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 15: the model stack, the front ends serving
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-7b"
VLM_PARAMS = 7_615_616_512     # its ModelConfig, all 28 layers
VLM_PROMPTS = (2, 2048)
VLM_GRID = 16     # a 448 x 448 image: 16 x 16 merged patches lead a prompt
VLM_STEPS = 32
AUDIO_ARCH = "whisper-medium"
AUDIO_PARAMS = 1_013_989_376   # its ModelConfig: 24 encoder, 24 decoder
AUDIO_PROMPTS = (2, 224)
AUDIO_MAX_LEN = 448            # Whisper's text context
AUDIO_STEPS = 64
NORM_NOISE = 0.02  # (c): norm weights 1 + 0.02 N(0, 1), biases 0.02 N(0, 1)


def grid_positions(b: int, s: int, grid: int, dev) -> torch.Tensor:
    """Qwen2-VL's positions (B, S, 3) for ``grid**2`` patches then text:
    patch ``i`` at (0, i // grid, i % grid), text token ``j`` at ``grid +
    j`` in all three streams."""
    p = grid * grid
    i = torch.arange(p, device=dev)
    patches = torch.stack([torch.zeros_like(i), i // grid, i % grid], -1)
    text = (grid + torch.arange(s - p, device=dev))[:, None].expand(-1, 3)
    return torch.cat([patches, text]).expand(b, s, 3)


def rope_float64(cfg, x, positions):
    """``apply_rope``'s formula evaluated in float64: the frequencies, the
    sections' streams, the angles and the rotation."""
    half = x.shape[-1] // 2
    inv = cfg.rope_theta ** (-torch.arange(
        half, dtype=torch.float64, device=x.device) * 2.0 / x.shape[-1])
    stream = torch.tensor([i for i, n in enumerate(cfg.mrope_sections)
                           for _ in range(n)], device=x.device)
    ang = positions.double()[..., stream] * inv
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = x.double()[..., :half], x.double()[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1), ang


def mrope_on_card(cfg, model, tp, patches, grid) -> dict:
    """(b): the prefill at Qwen2-VL's grid positions against the default
    ones (the logits must move); ``apply_rope`` at the grid positions on
    float32 values of the shape of a layer's q against its float64
    evaluation, within float32's own error for these angles: 2^-22 of max
    |x| times (the largest angle + 4), the angle's rounding and a few ulps
    of sin, cos and the rotation; then a decode step against ``forward``
    on the grid positions."""
    s = tp.shape[1]
    lp_grid, cache = MT.prefill(cfg, model, tp, s, positions=grid,
                                extra_embeds=patches)
    del cache
    lp_default, cache = MT.prefill(cfg, model, tp, s, extra_embeds=patches)
    del cache
    b = {"grid_vs_default": (lp_grid - lp_default).abs().max().item()}
    gen = torch.Generator(device=tp.device).manual_seed(151)
    x = torch.randn((tp.shape[0], s, cfg.n_heads, cfg.head_dim),
                    generator=gen, device=tp.device)
    got = ML.apply_rope(cfg, x, grid)
    want, ang = rope_float64(cfg, x, grid)
    scale = x.abs().max().item()
    b |= {"rope_max_abs_err": (got.double() - want).abs().max().item(),
          "rope_tolerance": 2.0 ** -22 * scale * (ang.max().item() + 4),
          "max_angle": ang.max().item(), "max_abs_x": scale,
          "rope_ms": time_ms(lambda: ML.apply_rope(cfg, x, grid), 10, 2)}
    del x, got, want, ang
    log(f"(b) M-RoPE, sections {cfg.mrope_sections}: the prefill at the grid "
        f"positions moves the last logits by up to {b['grid_vs_default']:.4f}"
        f" against the default positions; apply_rope on ({tp.shape[0]}, {s},"
        f" {cfg.n_heads}, {cfg.head_dim}) float32 at the grid positions "
        f"within {b['rope_max_abs_err']:.3e} of its float64 evaluation "
        f"(tolerance {b['rope_tolerance']:.3e}: angles up to "
        f"{b['max_angle']:.1f}, max |x| {scale:.3f}), {b['rope_ms']:.3f} ms")
    check(b["grid_vs_default"] > 0,
          "(b) the grid positions do not move the prefill's logits")
    check(b["rope_max_abs_err"] <= b["rope_tolerance"],
          f"(b) apply_rope against float64: {b}")
    b["d"] = decode_against_forward(cfg, model, tp, "b",
                                    {"extra_embeds": patches}, grid)
    return b


@torch.no_grad()
def redraw_norms(model, gen):
    """Every norm weight 1 + NORM_NOISE N(0, 1) and every norm bias
    NORM_NOISE N(0, 1), drawn on the card: under the reference's init
    rule they are all zero, and whisper's layernorm then computes zeros
    (ROADMAP R9).  Returns the count of values redrawn."""
    n = 0
    for path, _, p in model.leaves():
        name = path.split("/")[-1]
        if name.startswith(("ln", "final_norm")):
            p.normal_(0.0 if name.endswith("_b") else 1.0, NORM_NOISE,
                      generator=gen)
            n += p.numel()
    return n


def encode_timed(cfg, model, frames, card: str) -> dict:
    """(c): ``encode`` alone, after a warm-up: the median host wall of 3
    calls (each ending in a synchronize), a profiled call's device ms by
    kernel and the idle share."""
    MT.encode(cfg, model, frames)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = MT.encode(cfg, model, frames)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = call_kernel_ms(None, None, frames.device, "ssm_scan",
                          call=lambda: MT.encode(cfg, model, frames))
    e = {"frames": tuple(frames.shape), "wall_s": statistics.median(walls),
         "profiled": prof, "out_max_abs": out.abs().max().item()}
    e["idle_share"] = (1.0 - prof["device_ms"] / 1e3 / e["wall_s"]
                       if prof["device_ms"] else None)
    check(bool(torch.isfinite(out).all()) and e["out_max_abs"] > 0
          and prof["kernel_launches"] == 0,
          f"(c) encode gave non-finite or all-zero output: {e}")
    log(f"(c) encode of {e['frames']} frames on {card}: "
        f"{e['wall_s'] * 1e3:.2f} ms (median of 3); a profiled call: device "
        f"{prof['device_ms']:.2f} ms in {prof['launches']} launches (idle "
        f"share {e['idle_share']}); by kernel: "
        + "; ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}"
                    for k, v in prof["kernels"].items()))
    return e


def cross_entries_shared(cfg, model, tp, frames, max_len: int) -> dict:
    """(c): a decode step after the prefill shares ``xk`` and ``xv`` with
    the cache it was given (the same ``data_ptr``) and copies every other
    entry; the bytes of each."""
    _, cache = MT.prefill(cfg, model, tp, max_len, enc_frames=frames)
    _, new = MT.decode_step(cfg, model, cache, tp.shape[1],
                            tp[:, -1:])
    shared = copied = 0
    same = True
    for key, entry in cache.items():
        for name, t in entry.items():
            is_same = new[key][name].data_ptr() == t.data_ptr()
            cross = name in ("xk", "xv")
            same &= is_same == cross
            nbytes = t.numel() * t.element_size()
            if cross:
                shared += nbytes
            else:
                copied += nbytes
    del cache, new
    x = {"step_copies_bytes": copied, "shared_cross_bytes": shared,
         "cross_entries_shared": same}
    log(f"(c) a decode step copies {copied / 2**20:.1f} MiB of the cache (k, "
        f"v at max_len {max_len}) and shares xk, xv ({shared / 2**20:.1f} "
        f"MiB), the same data_ptr before and after: {same}")
    check(same, "(c) a decode step copied xk / xv or shared another entry")
    return x


def front_ends(dev, card: str) -> dict:
    """Phase 15: qwen2-vl-7b and whisper-medium at full width and depth."""
    t_start = time.perf_counter()
    out = {"live_at_start_bytes": torch.cuda.memory_allocated()}
    cfg, model, a = draw_model(dev, VLM_ARCH, VLM_PARAMS, "a")
    b, s = VLM_PROMPTS
    prompts = np.random.default_rng(151).integers(0, cfg.vocab_size,
                                                  VLM_PROMPTS)
    gen = torch.Generator(device=dev).manual_seed(152)
    patches = torch.randn((b, VLM_GRID ** 2, cfg.d_model), generator=gen,
                          device=dev) / math.sqrt(cfg.d_model)
    log(f"  M-RoPE sections {cfg.mrope_sections}; {VLM_GRID ** 2} seeded "
        f"patch embeddings {tuple(patches.shape)} lead each prompt")
    front = {"extra_embeds": patches}
    _, _, a["b"] = serve_timed(cfg, model, dev, prompts, VLM_STEPS, card,
                               "a", front=front)
    tp = torch.from_numpy(prompts).to(dev)
    out["a"] = a
    out["b"] = mrope_on_card(cfg, model, tp, patches,
                             grid_positions(b, s, VLM_GRID, dev))
    del model, patches, tp
    torch.cuda.empty_cache()
    out["qwen2_vl_s"] = time.perf_counter() - t_start

    cfg, model, c = draw_model(dev, AUDIO_ARCH, AUDIO_PARAMS, "c")
    c["norm_values_redrawn"] = redraw_norms(
        model, torch.Generator(device=dev).manual_seed(153))
    b, s = AUDIO_PROMPTS
    frames = torch.randn((b, cfg.enc_ctx, cfg.d_model), generator=torch
                         .Generator(device=dev).manual_seed(154), device=dev)
    prompts = np.random.default_rng(155).integers(0, cfg.vocab_size,
                                                  AUDIO_PROMPTS)
    log(f"  {cfg.enc_layers} encoder layers over {cfg.enc_ctx} frames, "
        f"cross-attention in every decoder layer; {c['norm_values_redrawn']}"
        f" norm weights and biases redrawn (1 + {NORM_NOISE} N(0, 1) and "
        f"{NORM_NOISE} N(0, 1): R9); seeded frames {tuple(frames.shape)}")
    c["encode"] = encode_timed(cfg, model, frames, card)
    _, _, c["b"] = serve_timed(cfg, model, dev, prompts, AUDIO_STEPS, card,
                               "c", front={"enc_frames": frames},
                               max_len=AUDIO_MAX_LEN)
    tp = torch.from_numpy(prompts).to(dev)
    c["cross"] = cross_entries_shared(cfg, model, tp, frames, AUDIO_MAX_LEN)
    out["c"] = c
    out["d"] = decode_against_forward(cfg, model, tp, "d",
                                      {"enc_frames": frames})
    del model, frames, tp
    torch.cuda.empty_cache()
    out["live_at_end_bytes"] = torch.cuda.memory_allocated()
    out["seconds"] = time.perf_counter() - t_start
    return out


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "falcon-mamba-7b"
TRAIN_LAYERS = 32      # of 64: the deepest of 24 and 32 under TRAIN_PEAK_GIB
#                        (peak 62.19 GiB in PERF.md's first run of phase 16)
TRAIN_BATCH = (2, 4096)  # B, S: the reference's train_4k sequence, one card
TRAIN_STEPS = 3
TRAIN_PEAK_GIB = 70.0
TRAIN_OPT = OptConfig(lr=3e-5, warmup_steps=1)  # the loss moves in 3 steps
DENSE_TRAIN_ARCH = "smollm-360m"
DENSE_TRAIN_PARAMS = 361_821_120  # its ModelConfig, all 32 layers
DENSE_TRAIN_BATCH = (4, 2048)  # (b): microbatches 2 against 1
LAUNCH_ARGS = ["--arch", "smollm-360m", "--steps", "6", "--batch", "8",
               "--seq", "128", "--n-docs", "2048", "--log-every", "1",
               "--device", "cuda"]  # (c), (d): the launcher's defaults
# (c) writes no checkpoint on the straight run (4.3 GB a save at full
# size); (d) takes two steps: phase 16 stays under a minute


def train_timed(cfg, model, dev, tokens, steps: int, what: str,
                mamba: int) -> tuple:
    """``make_train_step``'s step as the launcher calls it, after one
    warm-up step: the steps' wall (each ending in a synchronize), tokens/s,
    the losses, the peak memory, ``ssm_scan`` twice and ``ssm_scan_bwd``
    once a Mamba layer a step (``mamba`` of them), then one step profiled
    (device ms by kernel, the idle share).  Returns (model, log dict)."""
    b, s = tokens.shape
    step = make_train_step(cfg, None, TRAIN_OPT, loss_chunk=512)
    opt = adamw_init(model)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, m = step(model, opt, batch)
    first = m["loss"].item()
    first_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    walls, losses, moves = [], [], []
    for _ in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        losses.append(m["loss"].item())  # reads the loss: a synchronize
        walls.append(time.perf_counter() - t0)
        moves.append({k: v for k, v in counts().items()
                      if k in _build.launches})
    peak = torch.cuda.max_memory_allocated()
    for used in moves:
        check(used["ssm_scan"] == 2 * mamba and used["ssm_scan_bwd"] == mamba
              and all(v == 0 for k, v in used.items()
                      if k not in ("ssm_scan", "ssm_scan_bwd")),
              f"({what}) a step launched {used} ({mamba} Mamba layers)")
    check(all(math.isfinite(x) for x in [first] + losses)
          and losses[-1] < first, f"({what}) losses {first}, {losses}")
    prof = call_kernel_ms(None, None, dev, "ssm_scan", call=lambda: step(
        model, opt, batch), names=("ssm_scan_kernel", "ssm_scan_bwd_kernel",
                      "ssm_scan_bwd_kernel_sums"))
    wall = statistics.median(walls)
    out = {"first_step_s": first_s, "first_loss": first, "losses": losses,
           "step_s": walls, "step_s_median": wall,
           "tokens_per_s": b * s / wall, "max_memory_allocated": peak,
           "launches_per_step": moves[0], "profiled_step": prof,
           "idle_share": 1.0 - prof["device_ms"] / 1e3 / wall,
           "grad_norm": m["grad_norm"].item()}
    log(f"({what}) {TRAIN_STEPS} train steps (B={b}, S={s}) after a warm-up "
        f"step ({first_s:.2f} s): {', '.join(f'{w:.3f}' for w in walls)} s "
        f"({out['tokens_per_s']:.0f} tokens/s); loss {first:.4f} -> "
        f"{', '.join(f'{x:.4f}' for x in losses)}; peak "
        f"{peak / 2**30:.2f} GiB; launches a step {moves[0]}")
    log(f"  a profiled step: device {prof['device_ms']:.1f} ms in "
        f"{prof['launches']} launches (idle share {out['idle_share']:.3f}); "
        + "; ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}"
                    for k, v in prof["named"].items()) + "; by kernel: "
        + "; ".join(f"{k} {v['ms']:.2f} ms/{v['launches']}"
                    for k, v in prof["kernels"].items()))
    return model, out


def dense_microbatches(dev) -> dict:
    """(b) smollm-360m at full size: one step with microbatches 2 against
    1 from the same weights, at the reference's own tolerances (its
    tests/test_train.py: the loss within 1e-2, every parameter within
    rtol 2e-2 / atol 2e-3), each step timed."""
    vocab = model_registry.get_config(DENSE_TRAIN_ARCH).vocab_size
    tokens = torch.from_numpy(lm_token_stream(
        *DENSE_TRAIN_BATCH, vocab, seed=162)[0]).long().to(dev)
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10, grad_clip=0.0)
    out, params = {}, {}
    for mb in (1, 2):
        cfg, model, a = draw_model(dev, DENSE_TRAIN_ARCH, DENSE_TRAIN_PARAMS,
                                   "b")
        step = make_train_step(cfg, None, ocfg, microbatches=mb,
                               loss_chunk=512)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, _, m = step(model, adamw_init(model), {"tokens": tokens})
        loss = m["loss"].item()
        out[mb] = {"loss": loss, "step_s": time.perf_counter() - t0,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "params": a["params"]}
        params[mb] = [p.detach() for p in model.parameters()]
        del model
    diffs = [((p - q).abs() - 2e-3 - 2e-2 * q.abs()).max().item()
             for p, q in zip(params[2], params[1])]
    check(abs(out[1]["loss"] - out[2]["loss"]) < 1e-2 and max(diffs) <= 0,
          f"(b) microbatches 2 against 1: {out}, worst excess {max(diffs)}")
    del params
    torch.cuda.empty_cache()
    log(f"(b) smollm-360m ({out[1]['params']} parameters), B, S = "
        f"{DENSE_TRAIN_BATCH}: one step with microbatches 1: loss "
        f"{out[1]['loss']:.5f}, {out[1]['step_s']:.3f} s (first step), peak "
        f"{out[1]['max_memory_allocated'] / 2**30:.2f} GiB; microbatches 2: "
        f"loss {out[2]['loss']:.5f}, {out[2]['step_s']:.3f} s, peak "
        f"{out[2]['max_memory_allocated'] / 2**30:.2f} GiB; every parameter "
        f"within rtol 2e-2 / atol 2e-3 (worst margin {-max(diffs):.2e})")
    return out


def launcher_runs(dev) -> dict:
    """(c) ``launch.train.main --aba-batching`` on smollm-360m at full
    size: 6 steps straight, then 3 with ``--stop-after`` and a resume from
    the checkpoint; the last losses bitwise equal.  (d) ``--grad-compression
    --dp 2``: both data shards on the one card."""
    root = os.path.join(ROOT, "build", "phase16_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    try:
        for name, extra in (
                ("straight", ["--aba-batching"]),
                ("stopped", ["--aba-batching", "--ckpt-dir", root,
                             "--stop-after", "3"]),
                ("resumed", ["--aba-batching", "--ckpt-dir", root]),
                ("compressed", ["--grad-compression", "--dp", "2",
                                "--steps", "2"])):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            loss = launch_train.main(LAUNCH_ARGS + extra)
            out[name] = {"last_loss": loss,
                         "seconds": time.perf_counter() - t0,
                         "launches": {k: v for k, v in counts().items()
                                      if k in _build.launches}}
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(out["resumed"]["last_loss"] == out["straight"]["last_loss"]
          and all(math.isfinite(r["last_loss"]) for r in out.values())
          and out["straight"]["launches"]["auction_phase_dense"] > 0,
          f"(c), (d) the launcher: {out}")
    log(f"(c) the launcher, 6 steps straight {out['straight']['seconds']:.2f}"
        f" s, last loss {out['straight']['last_loss']!r}; 3 steps and a "
        f"checkpoint {out['stopped']['seconds']:.2f} s, the resume "
        f"{out['resumed']['seconds']:.2f} s, last loss "
        f"{out['resumed']['last_loss']!r}: bitwise equal; launches "
        f"{out['straight']['launches']}")
    log(f"(d) --grad-compression --dp 2 on the one card: "
        f"{out['compressed']['seconds']:.2f} s, last loss "
        f"{out['compressed']['last_loss']:.4f}")
    return out


def training(dev, card: str) -> dict:
    """Phase 16: training on the card."""
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"live_at_start_bytes": torch.cuda.memory_allocated(),
           "card": card}
    full = model_registry.get_config(TRAIN_ARCH)
    want = MT.n_params(dataclasses.replace(full, n_layers=TRAIN_LAYERS))
    cfg, model, a = draw_model(dev, TRAIN_ARCH, want, "a",
                               n_layers=TRAIN_LAYERS)
    a["training_state_bytes"] = 16 * a["params"]
    tokens = torch.from_numpy(lm_token_stream(
        *TRAIN_BATCH, cfg.vocab_size, seed=161)[0]).long().to(dev)
    a_log0 = model.blocks[0]["L0"].attn.a_log.detach().clone()
    model, a["steps"] = train_timed(cfg, model, dev, tokens, TRAIN_STEPS,
                                    "a", cfg.n_layers)
    moved = (model.blocks[0]["L0"].attn.a_log - a_log0).abs().max().item()
    check(moved > 0, "(a) a_log did not move: no gradient through the scan")
    check(a["steps"]["max_memory_allocated"] < TRAIN_PEAK_GIB * 2**30,
          f"(a) peak {a['steps']['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"  layer 0's a_log (its gradient only through the scan) moved by "
        f"up to {moved:.3e}; training state {a['training_state_bytes'] / 2**30:.2f}"
        f" GiB (16 B a parameter)")
    out["a"] = a
    del model, tokens, a_log0
    torch.cuda.empty_cache()
    out["b"] = dense_microbatches(dev)
    out["c"] = launcher_runs(dev)
    out["live_at_end_bytes"] = torch.cuda.memory_allocated()
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 16: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the launch layer
# ---------------------------------------------------------------------------

LAUNCH_BUDGET_S = 60.0
LAUNCH_ARCH = "granite-moe-3b-a800m"
LAUNCH_PARAMS = 3_903_186_432  # its ModelConfig, all 32 layers
# (b): no depth cut: parameters, gradients and both AdamW moments take 16 B
# a parameter, 62.45 GB (58.16 GiB) at all 32 layers before activations,
# under TRAIN_PEAK_GIB
LAUNCH_BATCH = (2, 2048)  # B, S
# (c): run_cell's cells, one child process a group, both started at the
# phase's start
DRYRUN_GROUPS = ((("deepseek-v2-236b", "prefill_32k", True),),
                 (("smollm-360m", "train_4k", False),
                  ("falcon-mamba-7b", "long_500k", False),
                  ("qwen2.5-14b", "decode_32k", False),
                  ("aba-pipeline", "aba_1m", False)))
DRYRUN_TIMEOUT_S = 600


def start_dryrun_cells() -> list:
    """One child process a group of DRYRUN_GROUPS, each running its cells
    through ``launch.dryrun.run_cell`` on ``meta`` tensors and printing
    their records as one JSON line; the children see no card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for cells in DRYRUN_GROUPS:
        code = (f"CELLS = {cells!r}\n"
                "import json, time\n"
                "t0 = time.perf_counter()\n"
                "from repro_torch.launch.dryrun import run_cell\n"
                "recs = [run_cell(a, s, multi_pod=m) for a, s, m in CELLS]\n"
                "print(json.dumps({'wall_s': time.perf_counter() - t0, "
                "'records': recs}))\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def stop_children(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_dryrun_cells(procs) -> list:
    """The children's records, each logged on a line of its own: every
    cell ``ok``, the ABA cell with its model FLOPs and no count."""
    recs = []
    for proc in procs:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        check(proc.returncode == 0, f"(c) a dry-run child failed: "
              f"{err[-3000:]}")
        child = json.loads(out.strip().splitlines()[-1])
        for rec in child["records"]:
            rec.pop("trace", None)
            rec["child_wall_s"] = child["wall_s"]
            log(json.dumps({"dryrun": rec}))
            recs.append(rec)
    for rec in recs:
        check(rec["status"] == "ok", f"(c) {rec['arch']} {rec['shape']} "
              f"{rec['mesh']}: {rec.get('error')}")
        counted = rec["arch"] != "aba-pipeline"
        check((rec["flops_per_device"] is not None) == counted
              and rec["model_flops_total"] > 0,
              f"(c) {rec['arch']} {rec['shape']}: {rec}")
        log(f"(c) {rec['arch']} {rec['shape']} {rec['mesh']}: "
            + (f"{rec['flops_per_device']:.4e} FLOPs and "
               f"{rec['bytes_per_device']:.4e} bytes a device, counted in "
               f"{rec['count_s']} s, dominant {rec['dominant']}, model "
               f"FLOPs {rec['model_flops_total']:.4e}" if counted else
               f"model FLOPs {rec['model_flops_total']:.4e}, not counted: "
               f"{rec['reason']}"))
    return recs


def abstract_models() -> dict:
    """(a): every config's ``Model`` on ``meta``: its parameters' shapes
    those of ``abstract_params``, their count and bytes."""
    out = {}
    for arch in model_registry.ALIASES:
        cfg = model_registry.get_config(arch)
        model = MT.Model(cfg, device="meta")
        abstract = MT.abstract_params(cfg)
        for path, b, p in model.leaves():
            want = abstract[path].shape
            check(tuple(p.shape) == (want if b is None else want[1:])
                  and p.is_meta, f"(a) {arch} {path}: {tuple(p.shape)}")
        count = sum(p.numel() for p in model.parameters())
        nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
        check(count == MT.n_params(cfg) == sum(
            math.prod(sd.shape) for sd in abstract.values()),
            f"(a) {arch}: {count} parameters")
        out[arch] = {"params": count, "bytes": nbytes}
        log(f"(a) {arch}: {count} parameters, {nbytes / 2**30:.2f} GiB "
            f"{cfg.param_dtype} on meta")
    return out


def grads_now(model) -> list:
    """The parameters' gradients, taken off the model."""
    out = [p.grad for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return out


def global_rel(got: list, want: list) -> float:
    """||got - want|| / ||want|| over all the tensors together."""
    num = sum(((g - w).double() ** 2).sum() for g, w in zip(got, want))
    den = sum((w.double() ** 2).sum() for w in want)
    return math.sqrt(num.item() / den.item())


def moe_over_model_axis(dev) -> dict:
    """(b): granite-moe-3b at full width and depth through a MODEL_MESH
    mesh of the one card against ``mesh=None``."""
    cfg, model, b = draw_model(dev, LAUNCH_ARCH, LAUNCH_PARAMS, "b")
    mesh = make_host_mesh(*MODEL_MESH, device="cuda")
    tokens = torch.from_numpy(lm_token_stream(
        *LAUNCH_BATCH, cfg.vocab_size, seed=171)[0]).long().to(dev)
    batch = {"tokens": tokens}
    b["layer"] = first_moe_against_mesh(cfg, model, tokens, mesh, "b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model.requires_grad_(True)
    losses, walls = {}, {}

    def loss_and_grads(name, c, me):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = MT.lm_loss(c, model, batch, mesh=me)
        loss.backward()
        losses[name] = loss.item()
        walls[name] = time.perf_counter() - t0
        return grads_now(model)

    for me in (mesh, None):  # warm-ups, untimed
        MT.lm_loss(cfg, model, batch, mesh=me).backward()
        grads_now(model)
    g_none = loss_and_grads("none", cfg, None)
    grad_err = global_rel(loss_and_grads("mesh", cfg, mesh), g_none)
    g_32 = loss_and_grads("float32", cfg32, None)
    grad_spread = global_rel(g_none, g_32)
    del g_none, g_32
    model.requires_grad_(False)
    torch.cuda.empty_cache()
    loss_err = abs(losses["mesh"] - losses["none"])
    loss_spread = abs(losses["none"] - losses["float32"])
    b |= {"losses": losses, "loss_and_grad_s": walls, "loss_err": loss_err,
          "loss_spread": loss_spread, "grad_err": grad_err,
          "grad_spread": grad_spread}
    log(f"(b) lm_loss and its gradients (B, S = {LAUNCH_BATCH}) through the "
        f"mesh: loss {losses['mesh']:.6f} against {losses['none']:.6f} "
        f"(float32 compute {losses['float32']:.6f}); the gradients within "
        f"{grad_err:.4e} of mesh=None by their global norm (bfloat16's "
        f"spread {grad_spread:.4e}, tolerance {SPREAD_FACTOR} x); forward and "
        f"backward {walls['mesh']:.3f} s against {walls['none']:.3f} s, "
        f"after a warm-up of each")
    check(all(math.isfinite(v) for v in losses.values())
          and loss_err <= SPREAD_FACTOR * loss_spread
          and grad_err <= SPREAD_FACTOR * grad_spread,
          f"(b) the loss and gradients through the mesh: {b}")

    opt = adamw_init(model)
    steps = {"none": make_train_step(cfg, None, TRAIN_OPT),
             "mesh": make_train_step(cfg, mesh, TRAIN_OPT)}
    model, opt, m = steps["none"](model, opt, batch)  # warm-up
    warm = m["loss"].item()
    torch.cuda.reset_peak_memory_stats()
    turns = []
    for name in MESH_TURNS:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = steps[name](model, opt, batch)
        loss = m["loss"].item()
        turns.append({"mesh": name, "step_s": time.perf_counter() - t0,
                      "loss": loss, "launches": {
                          k: v for k, v in counts().items()
                          if k in _build.launches}})
    peak = torch.cuda.max_memory_allocated()
    b |= {"warm_up_loss": warm, "steps": turns, "max_memory_allocated": peak}
    log(f"(b) train steps after a warm-up (loss {warm:.4f}), in turns: "
        + ", ".join(f"{t['mesh']} {t['step_s']:.3f} s (loss "
                    f"{t['loss']:.4f})" for t in turns)
        + f"; peak {peak / 2**30:.2f} GiB")
    check(all(math.isfinite(t["loss"]) for t in turns)
          and turns[-1]["loss"] < warm
          and peak < TRAIN_PEAK_GIB * 2**30,
          f"(b) the train steps: {turns}, peak {peak}")
    del model, opt, tokens
    torch.cuda.empty_cache()
    return b


def aba_1m_on_card(dev, x) -> dict:
    """(c'): the ``aba_1m`` cell run on the card over the production mesh's
    data shards, every position ``dev``."""
    mesh, fn, (spec,), cell = dryrun.lower_aba_cell(
        "aba_1m", multi_pod=False, device=dev)
    check(tuple(x.shape) == spec.shape and x.dtype == spec.dtype,
          f"(c') rows {tuple(x.shape)} {x.dtype} against {spec}")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = fn(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sizes = torch.bincount(labels.long(), minlength=cell["k"])
    used = {k: v for k, v in counts().items() if k in _build.launches}
    c = {"n": cell["n"], "d": cell["d"], "k": cell["k"],
         "fixed_rounds": cell["rounds"], "shards": mesh.shape["data"],
         "wall_s": wall, "sizes_min": int(sizes.min()),
         "sizes_max": int(sizes.max()), "launches": used}
    log(f"(c') aba_1m on the card: {cell['n']} x {cell['d']} rows into k = "
        f"{cell['k']} over {c['shards']} data shards in {wall:.3f} s; sizes "
        f"{c['sizes_min']}..{c['sizes_max']}; launches {used}")
    check(c["sizes_min"] == c["sizes_max"] == cell["n"] // cell["k"]
          and labels.shape == (cell["n"],), f"(c') not balanced: {c}")
    return c


def launch_layer(dev, card: str) -> dict:
    """Phase 17: the launch layer."""
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"live_at_start_bytes": torch.cuda.memory_allocated(),
           "card": card}
    cell = dryrun.ABA_CELLS["aba_1m"]
    rows = {}
    drawer = threading.Thread(target=lambda: rows.__setitem__(
        "x", make("lowrank", cell["n"], cell["d"], seed=0)))
    procs = start_dryrun_cells()
    drawer.start()
    try:
        out["a"] = abstract_models()
        out["b"] = moe_over_model_axis(dev)
        drawer.join()
        out["c_prime"] = aba_1m_on_card(dev, torch.from_numpy(rows.pop("x"))
                                        .to(dev))
        out["c"] = finish_dryrun_cells(procs)
    finally:
        drawer.join()
        stop_children(procs)
    out["live_at_end_bytes"] = torch.cuda.memory_allocated()
    out["seconds"] = time.perf_counter() - t_start
    log(f"phase 17: {out['seconds']:.1f} s (budget {LAUNCH_BUDGET_S} s)")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=PRESETS["diabetes"][0],
                    help="rows of the main-path run, cut for development "
                         "runs only (default: diabetes, 253680)")
    ap.add_argument("--profile-routes", action="store_true",
                    help="profile only the default and stream calls and "
                         "the dense kernel's rounds, print one JSON line "
                         "and exit")
    ap.add_argument("--labels", action="store_true",
                    help="print only the labels' digests of phases 3, 6 "
                         "and 7 as one JSON line and exit")
    ap.add_argument("--bid-top2-bits", action="store_true",
                    help="print only bid_top2's digests at phase 2's "
                         "shapes and exit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    if args.bid_top2_bits:
        log(json.dumps({"root": ROOT, "bid_top2": bid_top2_bits(dev)}))
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.profile_routes:
        _build.build_all()
        log(json.dumps({"profile_routes": profile_routes(dev, args.n, smi)}))
        return
    if args.labels:
        _build.build_all()
        log(json.dumps({"root": ROOT, "labels": label_digests(dev, args.n)}))
        return
    phase("phase 1: environment")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    parent_build = start_parent_bwd_build()  # beside the port's own build
    _build.build_all()
    log(f"kernel build {_build.build_seconds:.2f} s into {_build.BUILD_DIR}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():  # each entry, its registers and stack
            if any(w in line for w in ("entry function", "registers",
                                       "stack frame")):
                log(f"  ptxas {name}: {line.strip()}")

    phase("phase 2: kernels against their plain versions")
    err = check_bid_top2(dev)
    log(f"bid_top2 bits at phase 2's shapes on Gaussian floats: "
        f"{json.dumps(bid_top2_bits(dev))}")
    solve_rows = [measure_bid_top2(dev, err), check_and_measure_gather(dev)]
    laps = check_auction_phase(dev)
    solve_rows.append(measure_auction_phase(dev, laps))
    solve_rows[-1]["rounds_timed"] = time_rounds(
        laps[:4 * TIMED_LAPS], phase_kernel.auction_phase_timed,
        f"the first {TIMED_LAPS} LAPs of the main data")
    del laps
    dense_laps = check_auction_phase_dense(dev)
    dense_row = measure_auction_phase_dense(dev, dense_laps)
    del dense_laps
    masked_run = check_masked_dense(dev, args.n)
    dense_row["masked_lap"] = masked_run["masked_lap"]
    dense_row["rounds_timed"] = masked_run["rounds_timed"]
    hier_checks = check_hierarchical_phases(dev)
    dense_row["rounds_timed_hier"] = hier_checks["rounds_timed"]
    hier_checks["sequencer_lap"] = check_sequencer_lap(dev)
    hier_checks["mesh_laps"] = check_mesh_laps(dev)
    errs = check_entry_kernels(dev, torch.Generator().manual_seed(4))
    entry_rows = measure_entry_kernels(dev, errs)
    bwd_row = check_and_measure_ssm_scan_bwd(dev, parent_build)
    rows = solve_rows + [dense_row] + entry_rows + [bwd_row]
    log_rows(rows)

    phase("phase 3: the main path")
    main_run = main_path(dev, args.n, smi)
    for r in solve_rows:
        r["launches"] = main_run["launches"][r["name"]]
        r["launches_in"] = "phase 3: the anticluster main path"
    phase("phase 4: the path against its plain kernels")
    plain_run = against_plain(dev)
    phase("phase 5: the kernel entry point repro_torch.kernels")
    entry_run = entry_point(dev)
    for r in entry_rows:
        r["launches"] = entry_run["launches"][r["name"]]
    phase("phase 6: the default route at full size")
    default_run = default_route(dev, args.n, smi, main_run)
    dense_row["launches"] = default_run["launches"]["auction_phase_dense"]
    dense_row["launches_in"] = ("phase 6: the default route, "
                                "anticluster(x, k=256)")
    phase("phase 7: the constrained routes at full size")
    constrained_run = constrained_routes(dev, args.n, smi, masked_run)
    for r in rows:
        if r["name"] in ("auction_phase_dense", "gather_rows"):
            r["launches_phase7"] = {
                call: run["launches"][r["name"]]
                for call, run in constrained_run.items()}
    phase("phase 8: the hierarchical route at full size")
    hier_run = hierarchical_routes(dev, smi)
    for r in rows:
        if r["name"] in ("auction_phase_dense", "auction_phase", "bid_top2",
                         "gather_rows"):
            r["launches_phase8"] = {
                call: run["launches"].get(r["name"], 0)
                for call, run in hier_run.items() if isinstance(run, dict)}
    phase("phase 9: sessions at full size")
    session_run = sessions(dev, args.n, smi, default_run, main_run)
    for r in rows:
        if r["name"] in ("auction_phase_dense", "auction_phase", "bid_top2",
                         "gather_rows"):
            r["launches_phase9"] = {
                f"({call}) warm repartition {e + 1}": epoch["launches"][
                    r["name"]]
                for call in ("a", "b")
                for e, epoch in enumerate(session_run[call]["epochs"])}
            r["launches_phase9"]["(c) update"] = \
                session_run["c"]["launches"][r["name"]]
    phase("phase 10: the consumers at full size")
    consumer_run = consumers(dev, args.n, smi, default_run, main_run)
    phase("phase 11: the mesh route, the pipeline and the baselines")
    mesh_run_ = mesh_pipeline_baselines(dev, args.n, smi, default_run,
                                        main_run)
    for r in rows:
        if r["name"] in ("auction_phase_dense", "auction_phase", "bid_top2",
                         "gather_rows"):
            r["launches_phase11"] = {
                "(a) 2-shard mesh": mesh_run_["a"]["two_shards"]["launches"][
                    r["name"]],
                "(a) 2-shard mesh by shard": [
                    u[r["name"]] for u in
                    mesh_run_["a"]["two_shards"]["launches_by_shard"]],
                "(a) 1-shard mesh flat": mesh_run_["a"]["one_shard_flat"][
                    "launches"][r["name"]],
                "(a) 1-shard mesh stream": mesh_run_["a"]["one_shard_stream"][
                    "launches"][r["name"]]}
    phase("phase 12: the model stack: falcon-mamba-7b serving")
    model_run = model_stack(dev, smi)
    for r in rows:
        if r["name"] == "ssm_scan":
            r["launches_phase5"] = r["launches"]
            r["launches"] = model_run["b"]["ssm_scan_prefill"]
            r["launches_in"] = ("phase 12: Generator.generate on "
                                f"{MODEL_ARCH}, one a Mamba layer per prefill")
            r["launches_phase12"] = {
                "prefill": model_run["b"]["ssm_scan_prefill"],
                "decode steps": model_run["b"]["ssm_scan_decode"]}
            prof = model_run["b"]["profiled_prefill"]
            r["model_device_ms"] = (
                prof["kernel_ms"] / prof["kernel_launches"]
                if prof["kernel_launches"] else None)
    log(f"after phase 12: {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
        f"still allocated")
    phase("phase 13: the model stack: the dense attention family serving")
    dense_run = dense_stack(dev, smi)
    for r in rows:
        r["launches_phase13"] = {
            arch: run["b"]["kernel_launches"][r["name"]]
            for arch, run in ((DENSE_ARCH, dense_run),
                              (BIG_ARCH, dense_run["f"]))}
    phase("phase 14: the model stack: the MoE and MLA family and the "
          "hybrid serving")
    moe_run = moe_stack(dev, smi)
    for r in rows:
        r["launches_phase14"] = {
            arch: moe_run[arch]["b"]["kernel_launches"][r["name"]]
            for arch, *_ in MOE_MODELS}
    phase("phase 15: the model stack: the front ends serving")
    front_run = front_ends(dev, smi)
    for r in rows:
        r["launches_phase15"] = {
            arch: run["b"]["kernel_launches"][r["name"]]
            for arch, run in ((VLM_ARCH, front_run["a"]),
                              (AUDIO_ARCH, front_run["c"]))}
    phase("phase 16: training")
    train_run = training(dev, smi)
    per_step = train_run["a"]["steps"]["launches_per_step"]
    for r in rows:
        r["launches_phase16"] = {
            f"{TRAIN_ARCH} a step": per_step[r["name"]],
            **{f"launcher {k}": v["launches"][r["name"]]
               for k, v in train_run["c"].items()}}
        if r["name"] == "ssm_scan_bwd":
            r["launches"] = per_step["ssm_scan_bwd"]
            r["launches_in"] = (f"phase 16: make_train_step on {TRAIN_ARCH},"
                                " one a Mamba layer a step")
    phase("phase 17: the launch layer")
    launch_run = launch_layer(dev, smi)
    for r in rows:
        r["launches_phase17"] = {
            f"(b) {LAUNCH_ARCH} a step through the mesh":
                launch_run["b"]["steps"][0]["launches"][r["name"]],
            "(c') aba_1m": launch_run["c_prime"]["launches"][r["name"]]}
    phase("done")

    log(json.dumps({"main_path": main_run, "against_plain": plain_run,
                    "entry_point": entry_run, "default_route": default_run,
                    "masked_laps": masked_run,
                    "constrained_routes": constrained_run,
                    "hierarchical_checks": hier_checks,
                    "hierarchical_routes": hier_run,
                    "sessions": session_run, "consumers": consumer_run,
                    "mesh_pipeline_baselines": mesh_run_,
                    "model_stack": model_run, "dense_stack": dense_run,
                    "moe_stack": moe_run, "front_ends": front_run,
                    "training": train_run, "launch_layer": launch_run}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
