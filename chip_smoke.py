#!/usr/bin/env python3
"""Drive fbtt_embedding_tpu_torch on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (needs one
CUDA card and ``nvcc``). Phases, each printing its own lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile every kernel of ``fbtt_embedding_tpu_torch/csrc`` into
   ``build/`` (one ``nvcc`` per source, all at once) and load it; count
   the HMMA (tensor-core) instructions in B1's, B3's, B4's and B5's SASS
   (``cuobjdump``), which must not be 0;
3. kernels vs plain: the segment-transform kernel (B1) at both headline
   pass shapes in float32 and bfloat16, at one tt_ndim-2 and one tt_ndim-4
   pass, and folded by ``mm`` on block-diagonal tables (headline i2 mm=4,
   tt_ndim-4 pass 2 mm=4 and pass 3 mm=16, and last cores of ranks 16, 32
   and 64 by q 2, 4 and 8 folded by 4 in bfloat16, each of which must take
   the narrow tensor cores), each run twice and required bitwise equal,
   with the path each takes (the headline i1 and folded i2 passes in
   bfloat16 must take the tensor cores); the fused last-core training
   pass (B2) and the gradient pass (B3) at the headline training pass
   shapes and at two tt_ndim-4
   passes whose slabs take several staging chunks, on dense slabs and on
   block-diagonal tables folded by ``mm`` (headline i2 mm=4, tt_ndim-4
   pass 3 mm=16 and pass 2 mm=4), in float32 and bfloat16 (B3 with float32
   and bfloat16 z), on Zipf-skewed span tables with a sentinel tail, each
   run twice and required bitwise equal, with the path each takes
   (tensor cores, narrow tensor cores, narrow, CUDA cores; B3's headline
   i1 pass in bfloat16 must take the tensor cores); then last cores of ranks 16,
   32 and 64 by q 2, 4 and 8 folded by 4 in bfloat16, each of which must
   take the narrow tensor cores, and one of rank 4, which the kernels take
   folded by 2 only; the gradient
   pass with dG0 fused (B6) at the headline i1 pass (uniform and Zipf
   1.05 first-core rows), a tt_ndim-4 first pass and two tables, in float32
   and bfloat16, twice each and required bitwise equal, on the path B6's
   rule gives (the bfloat16 headline cases must take the tensor cores with
   dz0 over y; the headline's bfloat16 inputs also run on the dz0 tile and
   the CUDA cores), and B6's path rule asked of the library and of its
   Python copy on DG0_RULE_SHAPES, which must agree; the generic
   forward (B4) and backward (B5) in float32 on the headline batch
   (uniform and Zipf 1.05), a tt_ndim-2 model (uniform and Zipf 1.05), a
   small tt_ndim-4 model, the billion-row tt_ndim-4 model (P4, Q4, R4) at
   B=512, pooling 20 (uniform and Zipf 1.05), a tt_ndim-4 model of r_1 =
   12, a rank-64 model, two tables with weights, a live-count tail and a
   tt_ndim-3 model whose last core (q_0 q_1 = 12, r_2 = 8) B4 multiplies
   on the CUDA cores, B4 and B5 each run twice and required bitwise equal
   (B4 also where its wrapper sorts its pivot cores itself), each case
   printing and requiring B4's and B5's paths (the pivot path wherever
   the middle cores' slabs stage, tt_ndim 4 included; the chain pass at r_1
   = 12), the library's query and its Python copy agreeing, as they must
   on the shapes of FWD_RULE_SHAPES for both;
4. serve: the headline model (p=[200,220,250], q=[4,4,4], ranks [32,32]:
   E=11M, D=64) with random cores from seed 0 serves five requests of
   B=512 at pooling 20 (uniform and Zipf 1.05 row ids) and one of B=1024
   (pair mode), each held against the plain ``tt_rows`` path in float32,
   with the kernel's launch count checked per request; then the same
   model serves B=512 uniform and Zipf requests with ``impl="pallas"``
   (kernel B4) against the plain path in float32, B4 once per request;
   then the LFU cache at the reference benchmark's setting (``bench.py
   --cached``: direct mode, ``hashtbl_size`` = E, ``cache_size`` = 0.1 E)
   counts Zipf(1.05) traffic (counts checked exactly against a
   ``torch.bincount``), is populated, and serves two Zipf B=512 requests
   with ``probe_cache`` against the plain path, B1 twice per request;
4b. folded: the same params folded once (``make_folded_serving_fn``,
   bf16 and int8, without and with the populated cache: flat mode with a
   pair table of [p0*p1 + 1, q0*q1*r2] required; each fold's host seconds
   and bytes printed) serve B=512 at pooling 20 (uniform, Zipf 1.05, and
   Zipf probing the cache), B1 once per request and no plain kernel
   version: bf16 against the plain float32 serve and the unfolded serve
   within 5e-3 x max|out|, int8 against bf16 within 1e-2 x max|out| (the
   int8 pair table's rounding printed against its row absmax);
   ``refold_cache`` after one more populate against a fresh fold, bitwise;
   the bucketed front-end (``make_bucketed_serving_fn``) on four odd
   (B, nnz) requests against ``make_serving_fn`` on each exact shape;
   ``TTEmbeddingBag.freeze_for_serving`` against the module's forward;
   then device ms, host ms and device operations per request of the
   unfolded, bf16 and int8 serves (uniform and Zipf), in turns;
4c. pool: pools above 4096 rows (the deterministic
   ``ops.hot_scatter.segment_sum``): the folded serve at T=1, B=8192 and
   the DLRM's lookup (forward and backward, 8 tables of the walkthrough's
   width) at T=8, B=1024, each twice and required bitwise equal, against
   the plain float32 path (outputs within 5e-3 x max|out|, the core
   gradients by their cosine >= 0.99); then the pool's device time on
   those shapes, ``segment_sum`` against the parent's ``index_add_``, in
   turns;
5. train: the same model trains with fused SGD: five steps of B=512 at
   pooling 20 (uniform and Zipf 1.05), one of B=1024 (pair mode) and one
   of B=2048 (nnz 40960: autograd through the flat lookup), then one
   Adagrad step of B=512; each step's output and updated cores are held
   against the plain float32 step (``impl="xla", precision="highest"``)
   run from the same params, with the launches of B1, B2 and B3 checked
   per step, and TF32 checked off; then ``impl="pallas"`` (B4 forward, B5
   backward, float32) takes two SGD steps of B=512 (uniform, Zipf), one of
   B=2048 and one Adagrad step of B=512, each held against the plain
   float32 step, with B4 and B5 once and B1-B3 never per step; then the
   billion-row tt_ndim-4 model (P4, Q4, R4: E=10^9, D=64, random cores
   from seed 4) with ``impl="pallas"`` serves a uniform and a Zipf B=512
   request and takes two SGD steps and two with LFU counting into a hashed
   table of 2^24 slots and 2^20 rows, each held against the plain float32
   serve or step (counts, keys and slots exactly), B4 once per request and
   B4 and B5 once per step, with device ms, device operations and host ms
   of the serve and both steps (``[time] tt_ndim-4`` lines); then the
   reference benchmark's step: five SGD steps of B=512 with LFU counting
   on (``use_cache``; counts checked exactly), SGD and ``EXACT_ADAGRAD``
   steps on the populated cache with ``probe_cache`` (held against the
   plain float32 step from the same params and cache, cores and cache
   rows; the cache-row update run twice and required bitwise equal), each
   with B1, B2, B3 once; and with ``FBTT_DG0=fused`` steps of B=512,
   B=1024 (pair mode), B=2048 (autograd) and the cached B=512 step, with
   B6 once and B3 off the i1 pass;
5a. knobs: ``FBTT_PAIR`` and ``FBTT_FUSED_APPLY`` (``utils/knobs.py``,
   read at every call; ``describe()`` is printed after the device lines):
   the headline counting step (LFU counting on) under each setting of
   KNOB_RUNS, unset and each knob forced both ways at B=512 and B=2048,
   twice from the same state (outputs, cores and counts bitwise equal),
   held against the plain float32 step, with its launches of B1, B2 and
   B3 checked (B=512: unset 1, 1, 1; ``FBTT_PAIR=1`` 0, 1, 1;
   ``FBTT_FUSED_APPLY=0`` 2, 0, 2; B=2048: unset 1, 0, 2;
   ``FBTT_FUSED_APPLY=1`` 0, 1, 1; ``FBTT_PAIR=0`` 2, 0, 2); then each
   gate on against off, in turns on, off, off, on (device ms, device
   operations, host ms): ``FBTT_PAIR`` on the counting step over
   KNOB_PAIR_BS and on the DLRM's lookup forward + backward (T=8,
   pooling 8) over KNOB_DLRM_BS, ``FBTT_FUSED_APPLY`` on the counting
   step over KNOB_APPLY_BS, and where each pays;
5b. module: ``TTEmbeddingBag`` on the same model (approx-normal cores from
   seed 0, the LFU cache at its default sizes: direct, E rows counted,
   0.1 E cached) takes four forward + SGD ``backward`` calls of B=512 at
   pooling 20 (uniform and Zipf 1.05; counts checked exactly against a
   ``torch.bincount``), ``cache_populate()``, then two calls that probe the
   cache (each printing ``cache_hit_rate()``), one under ``FBTT_DG0=fused``
   and one with ``impl="pallas"``; an ``EXACT_ADAGRAD`` module on the
   populated cache with float32 staging, and in bfloat16 beside the fused
   step on the same state and batch; a ``sparse=False`` module (the core
   gradients and ``d_cache_weight``); a ``TableBatchedTTEmbeddingBag`` of
   two tables. Each call is held against a second module loaded with the
   same state (``impl="xla", precision="highest"``): output, cores and
   cache at the step's limits (float32 ones with ``impl="pallas"`` or
   float32 staging), with the launches of the forward and of the backward
   checked (B1 twice forward, B3 twice backward; B6 for B3's i1 pass under
   ``FBTT_DG0=fused``; B4 and B5 once with ``impl="pallas"``) and no plain
   kernel version or plain lookup run. Then ``full_weight()`` (11M x 64,
   float32) against single-id bags of the forward on 512 sampled rows, an
   ``import_full_weight`` round trip on a 110k-row model, and host-clock
   medians of the module's forward and forward + backward at B=512 with
   counting, beside the fused counting step, in turns;
5c. native+wide: (a) the native optimizers (``optim_semantics=
   "native"``: EXACT_ROWWISE_ADAGRAD, ADAM, PARTIAL_ROWWISE_ADAM, LAMB,
   PARTIAL_ROWWISE_LAMB, LARS_SGD) on the headline model, three counting
   steps each (B=512, pooling 20, uniform and Zipf 1.05; direct-mode LFU
   counting), B1, B2, B3 once a step: with float32 staging held against
   the plain float32 step (output 1e-4 x max|out|, each core's update
   within 1e-3 of the plain one's largest element plus the float32
   spacing at the core's largest element, the store's rounding, which
   LARS's ~1e-5-relative updates reach; the optimizer state's change
   within 1e-3 of the plain one's largest element, the step counter
   exactly), in bf16 by the cosine of each core's update
   against the plain one's (>= 0.99; the max relative error printed);
   native SGD and EXACT_ADAGRAD bitwise equal to the reference semantics;
   one native ADAM step with ``impl="pallas"`` (B4, B5) and one under
   ``FBTT_DG0=fused`` (B6 for B3); one native LAMB step probing the
   populated headline cache (its rows by row-wise Adagrad, held at 1e-6);
   (b) the wide-key cache on p=[1300, 1300, 1300] (E = 2.197e9, past
   2^31) at the headline widths, ``hashtbl_size`` 2^24, ``cache_size``
   2^20: Zipf(1.05) ranks spread over the ids, three in four at 2^31 or
   above, with pads of both forms; 20 counting steps of the fused SGD step
   (B1, B2, B3 once each), each distinct valid id found within MAX_PROBES
   of its hash with its key row and the host's count (``np.unique``), the
   parts equal to ``decompose_indices64`` and the pads counted nowhere;
   one batch counted into two copies of the state, bitwise equal; populate
   (the top counts, ties lowest slot first; rows within 1e-6 of the plain
   float32 ``tt_rows`` of their parts); SGD and EXACT_ROWWISE_ADAGRAD
   steps probing it, held as phase 5 holds its cached steps;
   ``make_serving_fn`` (B1 twice) and the bf16 fold (its mode printed: the
   pair table would be 1.7 GB) against the plain float32 serve; a
   ``TTEmbeddingBag`` at this table with ``use_cache``: four calls,
   ``cache_populate()``, one probed call (``cache_hit_rate()`` printed),
   each held against a plain module loaded with its state; then device
   ms, host ms and device operations per step, in turns, of the native
   ADAM and LAMB counting steps beside the reference SGD counting step,
   and of the wide counting step beside the direct-mode one;
5d. dlrm+tools: the DLRM trainer (``models/dlrm.py``) at the walkthrough's
   full width (8 tables of E=1M, p=[100, 100, 100], q=[4, 4, 4], ranks
   [32, 32]; dense 13, bottom MLP [512, 256, 64], top MLP [512, 256, 1];
   pooling 8, B=512, approx-normal from seed 0): five SGD steps with bf16
   staging (pair mode: B1 once forward, B3 twice backward), one with
   float32 staging (B1 twice, B3 twice) and one under ``FBTT_DG0=fused``
   (B1, B3 and B6 once), each held against the plain float32 step
   (``impl="xla", precision="highest"``) from the same params and batch:
   the loss and the pooled embeddings within 5e-3, the logits within
   DLRM_LOGIT_TOL of their largest, and each leaf's update by its cosine
   (>= 0.99; float32 staging: 1e-4 and 1e-3 of the largest element), with
   the launches checked and no plain kernel version or plain lookup run;
   one step under ``torch.cuda.set_sync_debug_mode("warn")`` (its
   synchronising calls counted); ``checkpoint.save`` / ``restore`` and
   ``save_npz`` / ``restore_npz`` into params from seed 99, the forward
   bitwise equal; ``guard_step(every=2)`` over four steps, and a NaN in core
   1 named by ``assert_finite``; ``examples.train_dlrm.main(["--steps",
   "40"])`` (loss must fall; B1 43, B3 80); ``python -m
   fbtt_embedding_tpu_torch.benchmark`` in process at its defaults (the
   reference headline, LFU counting on) with ``--run-baseline`` (B1, B2, B3
   113 times each: 3 + 10 + 100 steps) and with ``--impl pallas`` (B4, B5
   113 each), its us/nnz beside ``speed_of_light``; then the DLRM step's
   device ms, device operations and host ms, the device ms split into the
   lookup's forward + backward (``FBTT_PAIR`` unset, pair mode by nza,
   against "0", in turns; its
   pair-table build, one-hot pool and one-hot dG0 product) and the MLPs
   with the interaction;
5e. multi: ``torch.distributed`` worlds on the one card, each rank a
   fresh process (``chip_smoke.py --multi-child ...``; the kernels and the
   native loader built once here first), a world of 1 on NCCL, then one of
   2 on gloo (NCCL takes one rank a card; gloo takes CUDA tensors for
   all_reduce, all_gather and all_to_all, ``scripts/probe_gloo_cuda.py``).
   On each: the data-parallel SGD step (``make_sharded_fused_train_step``)
   of the headline model with LFU counting on (direct, ``hashtbl_size`` E,
   ``cache_size`` E / 10), global B=1024 at pooling 20, run twice from the
   same state (bitwise equal), the replicas' cores equal
   (``assert_replicas_agree``), the launches equal to one device's on the
   rank's block (B1, B2, B3; pair mode at 1024 a rank: B2, B3) and no
   plain version, the gathered output and the cores held against the
   single-device step on the whole batch (``hold_step``'s limits), the
   counts equal to its counts; then ten Zipf(1.05) batches from the
   native ``PrefetchLoader`` through ``csr_step_adapter`` (its output
   bitwise the fixed batch's; B2 and B3 once a step), the loader's
   batches/s alone and the step rate with it. On the world of 2 also the
   table-sharded DLRM at DLRM_KW on a ``(dp, mp) = (1, 2)`` mesh, twice
   (bitwise equal), held against the single-device DLRM step (loss at
   OUT_TOL, logits at DLRM_LOGIT_TOL, each leaf's update by its cosine),
   B1 and B3 launched, and ``examples.train_dlrm --steps 40 --mesh 1,2``
   (the loss must fall). Then on both worlds, with the LFU cache counted
   on 20 Zipf(1.05) batches of B=512 and populated (``cache_size`` E / 10,
   a multiple of the ranks) and a Zipf(1.05) global batch of 1024: the
   data-parallel serve (``make_dp_serving_fn``: folded bf16 and int8, not
   folded) against the single-device serve of its kind on the whole
   batch (bitwise on the world of 1, else within 5e-3 x max|out|; int8
   within 1e-2 of bf16; the folded ones B1 once a request); the
   replicated-cache lookup (``make_dp_cached_lookup``) against
   ``make_dp_lookup``; the table-owned step
   (``make_table_sharded_fused_train_step``) at the DLRM's width on a
   ``(1, n)`` mesh, SGD and native ADAM, against the single-device step
   on the whole batch (bitwise on the world of 1, else ``hold_step`` /
   the cosine); the row-owned cache: populate against
   ``shard_cache_weight_by_owner`` of ``cache_populate`` (counting fields
   exact), the lookup against ``make_dp_lookup`` and the replicated
   lookup, SGD and ``EXACT_ADAGRAD`` steps against the replicated-cache
   dp step with ``probe_cache`` (output and cores at ``hold_step``'s
   limits, owned rows and state within 3e-2 of the update, counts
   exact); each run twice, bitwise equal, with its launches and no plain
   version. Each step's and serve's device ms and operations, host ms and
   the collectives' host ms, per rank; a failing rank fails the run;
6. times: each kernel pass's time per call on two yardsticks, beside its
   bound and its plain version's on both: between CUDA events over
   back-to-back calls (the kernels' line's ``ms`` and ``plain_ms``; the
   wrappers' host work counts where it is slower than the kernels) and
   device time (``device_ms`` and ``plain_device_ms``: the summed
   durations of the call's kernels under ``torch.profiler``, each kernel
   named) (B1, B2, B3, B6, B4 and B5 on a uniform and a Zipf batch; B1, B2
   and B3 with the fold the pipeline passes; B1 beside one
   ``torch._grouped_mm`` call on the same inputs, the library yardstick),
   where an older tree is unpacked in ``build/ab_old/`` its B1, B2, B3 and
   B6 beside these on the same inputs
   (``scripts/time_span_kernels.py``, one process per run, in turns old,
   new, new, old) and its B4 and B5 on the generic cases
   (``scripts/check_generic_kernels.py``, likewise, with each pass's
   kernels); B4's and B5's bounds both at the float32 CUDA-core peak (the
   ``[time]`` lines) and, for the pivot passes, as three TF32 products at
   the tensor-core peak (``bound_ms``), beside each one's ``path`` (the
   kernels' line), on the headline batches and on the billion-row
   tt_ndim-4 model's (the kernels' line's ``ndim4``); host-clock
   medians of the serve per request, the training step per call at
   B=512, 1024 and 2048, the ``impl="pallas"`` serve and step at B=512, the B=512 step with LFU counting on (beside
   the reference's V100 figure), the cached step with its hit rate, the
   counting step with
   ``FBTT_DG0`` onehot against fused (alternating, one call),
   ``torch.nn.EmbeddingBag(11M, 64, mode="sum")`` forward on the serve's
   batch and, sparse, forward + backward + ``torch.optim.SGD`` step on the
   training batch.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

P, Q, R = [200, 220, 250], [4, 4, 4], [1, 32, 32, 1]
E, D = 200 * 220 * 250, 64
B, POOL = 512, 20
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,    # CUDA cores, no tensor cores
              "tf32": 495e12,      # dense tensor-core rate
              "bfloat16": 989e12}  # dense tensor-core rate
CSRC = "fbtt_embedding_tpu_torch/csrc/"
TT_FLAT = "fbtt_embedding_tpu/ops/pallas/tt_flat.py"
TT_KERNEL = "fbtt_embedding_tpu/ops/pallas/tt_kernel.py"
# (source, TPU kernel replaced) per kernel wrapper
KERNELS = {
    "seg_transform": (CSRC + "seg_transform.cu", TT_FLAT + ":338"),
    "seg_fused_i2": (CSRC + "seg_fused_i2.cu", TT_FLAT + ":774"),
    "seg_accum": (CSRC + "seg_accum.cu", TT_FLAT + ":436"),
    "seg_accum_dg0": (CSRC + "seg_accum_dg0.cu", TT_FLAT + ":595"),
    "tt_fwd": (CSRC + "tt_fwd.cu", TT_KERNEL + ":274"),
    "tt_bwd": (CSRC + "tt_bwd.cu", TT_KERNEL + ":400"),
}
# (q, inner ranks) on which B4's and B5's path rules are asked of the
# library and of their Python copies: tests/test_torch_port_fwd.py's and
# test_torch_port_bwd.py's path cases, and tt_ndim-3 shapes whose last
# core's product runs fused (r_2 = 32, q_2 4 and 8), on the tensor cores
# (r_2 16) and on the CUDA cores (q_0 q_1 = 4)
FWD_RULE_SHAPES = (
    ([8, 8], [32]), ([4, 4], [16]), ([4, 4, 4], [32, 32]),
    ([4, 4, 4], [64, 64]), ([2, 4, 2], [8, 8]), ([4, 4, 4], [12, 8]),
    ([4, 3, 4], [8, 5]), ([4, 4, 4, 4], [32, 32, 32]),
    ([4, 8, 4], [128, 128]), ([256, 256], [64]), ([4, 4, 8], [32, 32]),
    ([4, 4, 4], [32, 16]), ([2, 2, 4], [8, 8]), ([3, 4, 5], [16, 8]),
    ([2, 4, 2, 4], [32, 32, 32]), ([2, 2, 2, 2], [8, 8, 8]),
    ([2, 2, 2, 2], [16, 16, 16]), ([4, 4, 4, 4], [12, 8, 8]),
    ([4, 4, 3, 3], [8, 8, 5]), ([4, 4, 4, 4], [32, 32, 10]),
    ([2, 4, 2], [16, 8]), ([2, 4, 2], [12, 8]), ([4, 8, 4], [64, 64]),
    ([4, 4, 4], [30, 30]), ([4, 4, 4], [256, 256]),
)
# (blocks, bw_x, bw_y, seg, bfloat16) on which B6's path rule is asked of
# the library and of its Python copy: tests/test_torch_port_dg0.py's path
# cases, each limit of the rule from both sides
DG0_RULE_SHAPES = (
    (4, 32, 128, 64, True), (4, 32, 128, 64, False), (4, 24, 128, 64, True),
    (4, 32, 64, 64, True), (4, 32, 48, 64, True), (1, 64, 160, 64, True),
    (1, 80, 160, 64, True), (4, 32, 320, 64, True), (4, 32, 336, 64, True),
    (4, 80, 80, 64, True), (4, 96, 80, 64, True), (1, 32, 128, 16, True),
    (1, 32, 128, 8, True), (4, 128, 128, 64, False),
    (4, 136, 128, 64, False), (32, 32, 64, 16, True),
    (34, 32, 64, 16, True), (1, 8, 2048, 1, False), (1, 8, 2056, 1, False),
)
# phase 5e's paths, summed over the ranks of its worlds
MULTI_PATHS = ("train_multi_dp", "train_multi_csr", "train_multi_dlrm",
               "dlrm_walkthrough_mesh", "serve_multi_dp",
               "serve_multi_dp_int8", "lookup_multi_dp_cached",
               "train_multi_table_owned", "populate_multi_row_owned",
               "lookup_multi_row_owned", "train_multi_row_owned")
PATHS = ("serve", "train", "serve_generic", "train_generic",
         "serve_generic_ndim4", "train_generic_ndim4", "serve_cached",
         "train_cached", "train_dg0", "train_knobs", "module",
         "serve_folded", "serve_folded_int8", "train_native",
         "train_wide_cache",
         "serve_wide_cache", "module_wide_cache", "train_dlrm",
         "train_dlrm_f32", "train_dlrm_dg0", "dlrm_walkthrough", "cli",
         "cli_generic") + MULTI_PATHS
LR, EPS = 0.005, 1.0        # training steps of the check (EPS: Adagrad)
# bf16 staging against the float32 plain step: outputs within 5e-3 of
# max|out| (the serve's limit); each core's update within 3e-2 of its
# largest element (CPU rehearsal at B=64-128: up to 1.2e-2 under Zipf)
OUT_TOL, UPDATE_TOL = 5e-3, 3e-2
# the generic path (float32 throughout) against the plain float32 path:
# only the summation order differs
F32_OUT_TOL, F32_UPDATE_TOL = 1e-4, 1e-3
V100_US_PER_LOOKUP = 0.416  # BASELINE.md: the reference's published figure
# phase 5c: the native optimizers it trains, those with a step counter
NATIVE_OPTIMS = ("EXACT_ROWWISE_ADAGRAD", "ADAM", "PARTIAL_ROWWISE_ADAM",
                 "LAMB", "PARTIAL_ROWWISE_LAMB", "LARS_SGD")
NATIVE_MOMENTS = ("ADAM", "PARTIAL_ROWWISE_ADAM", "LAMB",
                  "PARTIAL_ROWWISE_LAMB")
# bf16 staging against the float32 plain step, for the optimizers that
# normalise by |g| (Adam, LAMB): the cosine of the core updates
COS_MIN = 0.99
# the wide-key cache's table (tests/test_cache_int64.py's p, E past 2^31)
# at the headline widths; its hash table and cache sizes; an odd multiplier
# (coprime with E - 2^31) spreading Zipf ranks over the ids
P_WIDE = [1300, 1300, 1300]
E_WIDE = 1300 ** 3
H_WIDE, C_WIDE = 2 ** 24, 2 ** 20
WIDE_MULT = 5000011
# phase 5d: the DLRM walkthrough's full configuration (8 tables of E=1M),
# its batch and learning rate
DLRM_KW = dict(num_tables=8, num_embeddings=1_000_000, embedding_dim=64,
               tt_p_shapes=[100, 100, 100], tt_q_shapes=[4, 4, 4],
               tt_ranks=[32, 32], dense_dim=13,
               bottom_mlp_dims=[512, 256, 64], top_mlp_dims=[512, 256, 1],
               pooling_factor=8)
DLRM_B, DLRM_LR = 512, 0.05
# bf16 staging against the float32 plain step: the pooled embeddings and
# the loss at OUT_TOL, the logits within 2e-2 of max|logit|. The interaction
# multiplies two staged embeddings and the top MLP sums the products with
# cancellation: on the CPU, with the kernels' plain versions staged in bf16,
# at this configuration and B=64, embeddings within 3.8e-3 of their largest
# gave logits within 7.2e-3 of theirs
DLRM_LOGIT_TOL = 2e-2
# phase 5's tt_ndim-4 model: the billion-row table (the JAX package's
# suggested_tt_shapes(10**9, 4)) at the headline's width (q from
# suggested_tt_shapes(64, 4)); its counting step counts into a hashed table
# of the wide cell's sizes (H_WIDE slots, C_WIDE rows)
P4, Q4, R4 = [125, 200, 200, 200], [2, 4, 2, 4], [1, 32, 32, 32, 1]
E4 = 125 * 200 ** 3
# phase 5e: the data-parallel step's global batch, and the steps per timing
MULTI_B, MULTI_STEPS = 1024, 10
# the calls per timing of the paths phase 5e added second (serves, lookups,
# the table-owned and row-owned steps)
MULTI_CALLS = 5


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps=25, inner=10):
    """Median over ``reps`` samples of the per-call time of ``inner``
    back-to-back calls between two CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


_NVML = []


def sm_clock_mhz():
    """Card 0's SM clock now (MHz), read through NVML (the NVIDIA
    management library, ``libnvidia-ml``), or None where it cannot be
    read."""
    if not _NVML:
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            handle = ctypes.c_void_p()
            if lib.nvmlInit_v2() or lib.nvmlDeviceGetHandleByIndex_v2(
                    0, ctypes.byref(handle)):
                raise OSError("NVML did not start")
            _NVML.append((lib, handle))
        except OSError:
            _NVML.append(None)
    if _NVML[0] is None:
        return None
    lib, handle = _NVML[0]
    mhz = ctypes.c_uint()
    nvml_clock_sm = 1
    if lib.nvmlDeviceGetClockInfo(handle, nvml_clock_sm, ctypes.byref(mhz)):
        return None
    return mhz.value


def mhz_text(mhz):
    return "SM clock not read" if mhz is None else f"SM clock {mhz} MHz"


PROFILER_PAD_S = 0.02  # untimed calls on each side of device_ms's window
PROFILER_TRIES = 3
WORLD_PAD_CALLS = 5  # untimed calls on each side of world_device_ms's window


def device_ms(fn, n=20):
    """(device ms per call, {kernel name: ms per call}, SM MHz): the summed
    durations of the device work ``fn`` launches (kernels, copies, fills),
    over ``n`` calls under ``torch.profiler`` after warm-up, and the SM
    clock read as the last call is launched (:func:`sm_clock_mhz`). Host
    time between launches does not count, so a call whose Python side takes
    longer than its kernels still reads what the device spent on it.

    The tracer can miss the work at the start or the end of a session (on
    the H100, after other processes profiled the card: a session of 20
    calls kept 5 of their kernels). So the ``n`` calls run between
    PROFILER_PAD_S seconds of untimed calls on each side, and only the
    device work between two marker kernels (``torch.cuda._sleep``) queued
    on the stream just before the first call and just after the last
    counts. (A ``record_function`` window's span on the device, used
    before, left out the last call's backward kernels of the DLRM step,
    launched by the autograd engine's thread.) Each call launches the same
    work, so a session is kept only where the tracer kept both markers and
    the window holds every kernel name a whole number of times per call;
    one that does not is announced by a ``[warn]`` line with its counts
    and run again, up to PROFILER_TRIES sessions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PROFILER_PAD_S:
            fn()
        torch.cuda.synchronize()

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for k in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            torch.cuda._sleep(1)  # a marker kernel before the calls
            for _ in range(n):
                fn()
            torch.cuda._sleep(1)  # and one after them
            mhz = sm_clock_mhz()
            torch.cuda.synchronize()
            pad()
        cuda = [ev for ev in prof.events()
                if ev.device_type == DeviceType.CUDA]
        spins = sorted((ev.time_range for ev in cuda
                        if "spin_kernel" in ev.name), key=lambda r: r.start)
        per, count = {}, {}
        if len(spins) == 2:
            lo, hi = spins[0].end, spins[1].start
            for ev in cuda:
                if lo <= ev.time_range.start and ev.time_range.end <= hi:
                    per[ev.name] = (per.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us())
                    count[ev.name] = count.get(ev.name, 0) + 1
        if per and not any(c % n for c in count.values()):
            per = {k: v / n / 1e3 for k, v in per.items()}
            device_ms.ops = sum(count.values()) / n
            return sum(per.values()), per, mhz
        short = {}
        for name, c in count.items():
            short[kernel_name(name)] = short.get(kernel_name(name), 0) + c
        print(f"[warn] device_ms: profiler session {k + 1} of "
              f"{PROFILER_TRIES} kept {len(spins)} of the 2 marker kernels "
              f"and recorded device events {short or 'none'} between them "
              f"for {n} calls", flush=True)
    fail(f"torch.profiler lost device events in {PROFILER_TRIES} sessions")


device_ms.ops = None  # device operations per call, of the last reading


def kernel_times(fn, ref_fn, plain_reps=25, plain_inner=10):
    """One wrapper and its plain version on the same inputs, on two
    yardsticks: ``ms`` and ``plain_ms``, per call between CUDA events over
    back-to-back calls (``cuda_ms``: the wrappers' host work counts where
    it is slower than the kernels), and ``device_ms`` and
    ``plain_device_ms``, the device time per call (``device_ms``); with
    ``parts``, the text of the kernels' device us, and ``sm_mhz``, the SM
    clock in the kernel's window."""
    k_dev, per, mhz = device_ms(fn)
    return {
        "ms": cuda_ms(fn),
        "plain_ms": cuda_ms(ref_fn, reps=plain_reps, inner=plain_inner),
        "device_ms": k_dev,
        "plain_device_ms": device_ms(ref_fn, n=5)[0],
        "parts": " + ".join(f"{kernel_name(name, True)} {ms * 1e3:.2f}"
                            for name, ms in per.items()),
        "sm_mhz": mhz,
    }


def times_text(t):
    """The line of one ``kernel_times`` reading (us), with its bound."""
    return (f"kernel {t['ms'] * 1e3:.2f} us between events, "
            f"{t['device_ms'] * 1e3:.2f} us on the device ({t['parts']}; "
            f"{mhz_text(t['sm_mhz'])}); "
            f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}); plain "
            f"{t['plain_ms'] * 1e3:.2f} us between events, "
            f"{t['plain_device_ms'] * 1e3:.2f} us on the device")


def kernel_name(full, templates=False):
    """A device kernel's name without namespaces, templates and arguments;
    with ``templates``, its template arguments kept (B4's and B5's pivot
    passes of one kernel template at two tt_ndim)."""
    import re

    names = [w for w in re.findall(r"(\w+)\s*[<(]", full)
             if w not in ("void", "anonymous")]
    if not names:
        return full[:40]
    args = re.match(r"\s*(<[^()]*>)\s*\(", full.split(names[0], 1)[1])
    return names[0] + (args.group(1) if templates and args else "")


def host_ms(fn, reps=25):
    """Median host-clock time of one call ending in a synchronise."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def span_case(rng, nza, blocks, bw_in, bw_out, p_rows, dtype, seg,
              y_width=None, mm=1):
    """Kernel inputs with duplicate-heavy sorted keys (Zipf over the core
    rows, so many rows own no span), a sentinel tail of dead rows, and
    random x (and y, ``y_width`` wide) and table scaled so that outputs,
    and the hottest span's gradient sum, are of unit size. With ``mm > 1``
    the table is block-diagonal, ``kron(I_mm, G[j])`` of a random ``G``, as
    the pipeline builds it past the first core."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import (
        SPAN_BLOCK,
        _bd_table,
        _span_table,
    )

    keys = (rng.zipf(1.3, size=nza) - 1) % p_rows
    keys[rng.random(nza) < 0.05] = p_rows  # dead lookups: sentinel span
    keys = np.sort(keys)
    # x and y rows scale so that the hottest span's sum of x^T y is ~1
    # (y only when there is one; B1's x stays unit-size, as before)
    hot = np.bincount(keys[keys < p_rows]).max() * blocks
    sx = hot ** -0.25 if y_width else 1.0
    keys = torch.as_tensor(keys.astype(np.int32), device="cuda")
    runs, first, cnt = _span_table(keys, p_rows, nza // seg, seg=seg)

    def draw(shape, scale):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device="cuda")

    x = draw((nza, blocks * bw_in), sx).to(dtype)
    kx, ky = bw_in // mm, bw_out // mm
    g = draw((p_rows + SPAN_BLOCK, kx, ky),
             1 / (sx * np.sqrt(max(kx, ky) if y_width else kx)))
    g[p_rows:] = 0
    table = _bd_table(g, mm, torch.float32).reshape(-1, bw_out)
    if y_width is None:
        return runs, first, cnt, x, table.to(dtype)
    y = draw((nza, blocks * y_width), sx).to(dtype)
    return runs, first, cnt, x, y, table.to(dtype)


def pass_bound(runs, nseg, x, blocks, bw_in, bw_out, p_rows, out_dtype,
               mm=1):
    """(least ms, bound_by) for one B1 pass on these inputs: each x row read
    once, each y row written once, each live slab read once, the span
    tables read once; multiply-adds of the live rows only. With a
    block-diagonal table (``mm > 1``) the work is the folded one: each live
    slab is its ``[bw_in/mm, bw_out/mm]`` block G[j], and each row does
    1/mm of the dense multiply-adds."""
    import torch

    nza = x.shape[0]
    spans = runs[1:p_rows + 1] - runs[:p_rows]
    live_rows = int(spans.sum())
    live_slabs = int((spans > 0).sum())
    isz = x.element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (nza * blocks * bw_in * isz + nza * blocks * bw_out * osz
              + live_slabs * bw_in * bw_out * isz // (mm * mm)
              + (runs.numel() + 2 * nseg) * 4)
    flops = 2.0 * live_rows * blocks * bw_in * bw_out / mm
    peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grad_pass_bound(runs, nseg, x, blocks, bw_x, bw_y, p_rows, z_dtype,
                    rows_out, dg0_rows=0, mm=1):
    """(least ms, bound_by) for one B3 (or, with ``rows_out``, B2; with
    ``dg0_rows``, B6) pass on these inputs: x and y read once, z (and rows)
    written once, each live slab read once, acc written once, the span
    tables read once; multiply-adds of the live rows only (two products,
    three for B2). With a block-diagonal table (``mm > 1``) the work is
    the folded one: each live slab is its ``[bw_x/mm, bw_y/mm]`` block G[j],
    acc is ``[p_rows, bw_x/mm, bw_y/mm]``, and each row does 1/mm of the
    dense multiply-adds (the off-diagonal ones are products with zeros). B6
    writes no z: it reads each row's first-core id once, writes dG0
    ``[dg0_rows, blocks*bw_x]`` once and adds each live row's dz0 into
    it."""
    import torch

    nza = x.shape[0]
    spans = runs[1:p_rows + 1] - runs[:p_rows]
    live_rows = int(spans.sum())
    live_slabs = int((spans > 0).sum())
    isz = x.element_size()
    zsz = torch.empty((), dtype=z_dtype).element_size()
    nbytes = (nza * blocks * (bw_x + bw_y) * isz
              + (nza * 4 + dg0_rows * blocks * bw_x * 4 if dg0_rows
                 else nza * blocks * bw_x * zsz)
              + (nza * blocks * bw_y * isz if rows_out else 0)
              + (live_slabs * isz + p_rows * 4) * bw_x * bw_y // (mm * mm)
              + (runs.numel() + 2 * nseg) * 4)
    flops = (2.0 * live_rows * blocks * bw_x * bw_y // mm
             * (3 if rows_out else 2))
    if dg0_rows:
        flops += live_rows * blocks * bw_x
    peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def span_path(kname, dtype, blocks, bw_x, bw_y, mm):
    """The path B1, or kernel 1 of B2 or B3, takes on these widths, as its
    library chooses it (and the fold the wrapper passes, where not all of
    ``mm``)."""
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels import (
        seg_accum,
        seg_fused_i2,
        seg_transform,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.tt_flat import SEG

    mod = {"seg_fused_i2": seg_fused_i2,
           "seg_transform": seg_transform}.get(kname, seg_accum)
    fold, path = seg_accum.kernel_fold(
        kname, getattr(mod._lib(), f"fbtt_{kname}_path"),
        dtype == torch.bfloat16, SEG, blocks, bw_x, bw_y, mm)
    return seg_accum.PATH_NAMES[path] + (
        f", folded by {fold}" if fold != mm else "")


def grouped_mm_call(runs, x, table, blocks, bw_in, bw_out, p_rows, mm):
    """(call, note): one ``torch._grouped_mm`` computing B1's y on these
    inputs, the library yardstick: x viewed as ``[nza * nb, kx]`` keeps the
    rows of span j contiguous at ``runs[j] * nb .. runs[j+1] * nb``, one
    group per span up to the sentinel span, whose slab is zeros. On the
    folded slabs ``G[j]`` where it takes them, else on the dense slabs (it
    wants 16-byte rows: a folded ky of 4 is 8 bytes); ``call`` is None where
    it takes neither, and ``note`` says why."""
    import torch

    notes = []
    for fold in sorted({mm, 1}, reverse=True):
        nb, kx, ky = blocks * fold, bw_in // fold, bw_out // fold
        a = x.reshape(-1, kx)
        b = table[:(p_rows + 1) * bw_in].reshape(p_rows + 1, bw_in, bw_out)
        b = b[:, :kx, :ky].contiguous()
        offs = (runs[1:p_rows + 2] * nb).to(torch.int32).contiguous()

        def call(a=a, b=b, offs=offs):
            return torch._grouped_mm(a, b, offs=offs)

        try:
            call()
            torch.cuda.synchronize()
        except (RuntimeError, AttributeError, TypeError) as e:
            notes.append(f"refused at fold {fold} ({kx} x {ky}): "
                         f"{str(e).splitlines()[0][:120]}")
            continue
        where = "folded slabs" if fold > 1 else "dense slabs"
        return call, "; ".join(notes + [f"on the {where}, {kx} x {ky}"])
    return None, "; ".join(notes)


def i0_rows(rng, runs, p_rows, nza, tp0, zipf):
    """First-core row of every sorted row of a ``span_case``: uniform or
    Zipf(1.05) over [0, tp0), the sentinel tp0 on the sentinel span's
    rows."""
    import numpy as np
    import torch

    i0 = ((rng.zipf(1.05, size=nza) - 1) % tp0 if zipf
          else rng.integers(0, tp0, size=nza))
    i0[int(runs[p_rows]):] = tp0
    return torch.as_tensor(i0.astype(np.int32), device="cuda")


def generic_inputs(rng, p, q, ranks, b, pool, tables=1, zipf=False,
                   weights=False, live=None):
    """The generic kernels' arguments for one batch of random cores (from
    ``rng``) and uniform or Zipf(1.05) row ids, made by the host drivers'
    own helpers: (kernel cores, ids, pooled rows, weights, bag order, bag
    starts, the backward's schedule, dout)."""
    import numpy as np
    import torch

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import tt_kernel

    rfull = [1] + list(ranks) + [1]
    e, d = int(np.prod(p)), int(np.prod(q))
    nnz = tables * b * pool

    def dev(a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    cores = [dev(c, torch.float32) for c in fbt.init_tt_cores(
        rng, "uniform", tables, e, d, p, q, rfull)]
    ids = ((rng.zipf(1.05, size=nnz) - 1) % e if zipf
           else rng.integers(0, e, size=nnz))
    rowidx = dev(np.arange(nnz) // pool % b)
    tbl = dev(np.arange(nnz) // (b * pool)) if tables > 1 else None
    w = dev(rng.random(nnz), torch.float32) if weights else None
    lc = dev([int(live * nnz)]) if live is not None else None
    parts = fbt.decompose_indices(dev(ids, torch.int64), p)
    gk = tt_kernel._kernel_cores(cores, p, q, rfull)
    idx, rowv, wv = tt_kernel.block_inputs(parts, rowidx, tbl, w, lc, p,
                                           tables, b)
    order, starts = tt_kernel.bag_order(rowv, tables * b)
    sched = tt_kernel.core_orders(idx, rowv, [tables * x for x in p],
                                  tt_kernel.SEG)
    dout = dev(rng.standard_normal((tables * b, d)), torch.float32)
    return gk, idx, rowv, wv, order, starts, sched, dout


def generic_bound(gk, idx, rowv, weights, tb, backward, tf32x3=False):
    """(least ms, bound_by) of B4 (or, with ``backward``, B5) on these
    inputs: the core rows the live lookups touch read once, ids, pooled
    rows and weights read once, the output written once (B4 ``[tb, D]``;
    B5 every core's gradient, and it reads ``dout``); multiply-adds of the
    live lookups only: the chain (B4), or the forward up to the last
    core's input, the cotangent back through every core and each core's
    outer product (B5), at the float32 CUDA-core peak, or with ``tf32x3``
    three TF32 products each at the TF32 tensor-core peak (the pivot passes
    of B4 and B5)."""
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import chain_dims

    q, r = chain_dims(gk)
    live = rowv >= 0
    n_live = int(live.sum())
    m = [1]
    for qq in q:
        m.append(m[-1] * qq)  # m[t + 1] = q_0 * .. * q_t
    nbytes = sum(int(torch.unique(idx[t][live]).numel()) * g[0].numel() * 4
                 for t, g in enumerate(gk))
    nbytes += (idx.numel() + rowv.numel()) * 4 + tb * m[-1] * 4
    if weights is not None:
        nbytes += weights.numel() * 4
    step = [m[t] * r[t] * q[t] * r[t + 1] for t in range(1, len(q))]
    if backward:
        nbytes += sum(g.numel() for g in gk) * 4
        macs = sum(step[:-1]) + 2 * sum(step)
    else:
        macs = sum(step)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2.0 * macs * n_live * (3 if tf32x3 else 1)
             / PEAK_FLOPS["tf32" if tf32x3 else "float32"])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def hold_step(line, out, ref_out, new, ref, old, out_tol, update_tol, what,
              store_ulp=False):
    """Hold a training step's output and core updates against the plain
    step's; returns ``line`` with the errors appended. ``store_ulp``: the
    limit adds the float32 spacing at the core's largest element, the
    rounding of storing ``c - lr * u`` (an update below ~1e-4 of the
    cores, LARS's, is not held to 1e-3 of itself by float32 cores)."""
    import torch

    scale = ref_out.abs().max().item()
    err = (out - ref_out).abs().max().item()
    line += f"; output max_abs_err {err:.3e} (limit {out_tol} x {scale:.3e})"
    if not err <= out_tol * scale:
        fail(f"{what}: output disagrees with the plain step")
    for t, (c_new, c_ref, c_old) in enumerate(zip(
            new.tt_cores, ref.tt_cores, old.tt_cores)):
        upd = (c_ref - c_old).abs().max().item()
        cerr = (c_new - c_ref).abs().max().item()
        limit = update_tol * upd
        line += (f"; core {t} max|dcore - dcore_plain| {cerr:.3e} "
                 f"(limit {update_tol} x max|dcore_plain| {upd:.3e}")
        if store_ulp:
            spacing = (torch.finfo(torch.float32).eps
                       * c_old.abs().max().item())
            limit += spacing
            line += f" + float32 spacing at max|core| {spacing:.3e}"
        line += ")"
        if not (torch.isfinite(c_new).all() and cerr <= limit):
            fail(f"{what}: core {t} update disagrees with the plain step")
    return line


def hold_cache(line, new, ref, old, what):
    """Hold a cached step's cache against the plain step's: counts and
    slots exactly, the cache rows' update (and optimizer state) within
    1e-6 of its largest element; returns ``line`` with the errors."""
    import torch

    for f in ("keys", "freq", "slots"):
        if not torch.equal(getattr(new, f), getattr(ref, f)):
            fail(f"{what}: cache {f} differs from the plain step's")
    for f in ("weight", "opt_state"):
        a, b, o = getattr(new, f), getattr(ref, f), getattr(old, f)
        if not a.numel():
            continue
        upd = (b - o).abs().max().item()
        err = (a - b).abs().max().item()
        line += (f"; cache {f} max|d - d_plain| {err:.3e} (limit 1e-6 x "
                 f"max|d_plain| {upd:.3e})")
        if f == "weight" and upd == 0:
            fail(f"{what}: the step updated no cache row")
        if not err <= 1e-6 * upd:
            fail(f"{what}: cache {f} update disagrees with the plain step")
    return line


@contextlib.contextmanager
def knob(env):
    """The ``FBTT_*`` knobs of ``env`` ({name: value}, None unsets; each
    registered in ``utils.knobs``, else KeyError) in this process for the
    block, then as before. The library reads them at every call."""
    from fbtt_embedding_tpu_torch.utils import knobs

    before = {}
    for name in env:
        knobs.get_str(name)
        before[name] = os.environ.get(name)
    try:
        for name, value in env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        yield
    finally:
        for name, value in before.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def clone_cache(c):
    from fbtt_embedding_tpu_torch.ops.cache import CacheState

    return CacheState(*(t.clone() for t in (c.keys, c.freq, c.slots,
                                            c.weight, c.opt_state)))


@contextlib.contextmanager
def plain_watch():
    """Count, inside the block, the calls of every kernel's plain version
    and of the plain lookup chain (``ops.lookup.tt_forward``): yields a
    dict {function name: calls} that stays empty where none ran."""
    import importlib

    pkg = "fbtt_embedding_tpu_torch.ops."
    targets = [(pkg + "kernels." + stem, stem + "_plain") for stem in (
        "seg_transform", "seg_fused_i2", "seg_accum", "seg_accum_dg0",
        "tt_fwd", "tt_bwd")] + [(pkg + "lookup", "tt_forward")]
    calls, saved = {}, []
    for mod_name, name in targets:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def generic4_phase(fbt, card, wrappers):
    """Phase 5's tt_ndim-4 part: the billion-row model (P4, Q4, R4; random
    cores from seed 4) served and trained with ``impl="pallas"`` at B=512,
    pooling 20, uniform and Zipf(1.05) ids: two requests, two SGD steps and
    two with LFU counting into a hashed table (H_WIDE slots, C_WIDE rows),
    each held against the plain float32 serve or step on the same inputs
    (outputs and core updates at F32_OUT_TOL and F32_UPDATE_TOL; the counts'
    keys, counts and slots exactly), with B4 once per request and B4 and B5
    once per step and no plain kernel version; then device ms, device
    operations and host ms per request and step. Returns the launches of
    the serve and the steps by path."""
    import numpy as np
    import torch

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def clone(prm):
        return fbt.TTEmbeddingParams(
            tuple(c.clone() for c in prm.tt_cores), (),
            clone_cache(prm.cache) if prm.cache is not None else None)

    rng = np.random.default_rng(6)

    def batch(zipf):
        n = B * POOL
        ids = ((rng.zipf(1.05, size=n) - 1) % E4 if zipf
               else rng.integers(0, E4, size=n))
        return (torch.as_tensor(ids.astype(np.int32), device="cuda"),
                torch.arange(0, n + 1, POOL, device="cuda"),
                torch.as_tensor(rng.standard_normal((1, B, D)),
                                dtype=torch.float32, device="cuda"))

    zeros = dict.fromkeys(wrappers, 0)
    paths = {"serve_generic_ndim4": dict(zeros),
             "train_generic_ndim4": dict(zeros)}
    t0 = time.perf_counter()
    cores = fbt.init_tt_cores(np.random.default_rng(4), "uniform", 1, E4, D,
                              P4, Q4, R4)
    params = fbt.params_from_jax(cores, device="cuda")
    batches = [batch(z) for z in (False, True)]
    serve = fbt.make_serving_fn(P4, Q4, R4, 1, B, impl="pallas",
                                device="cuda")
    plain = fbt.make_serving_fn(P4, Q4, R4, 1, B, impl="xla", device="cuda")
    for zipf, (idx, offs, _) in zip((False, True), batches):
        zero_counts()
        with plain_watch() as plains:
            out = serve(params, idx, offs)
            torch.cuda.synchronize()
        got = counts()
        for k in wrappers:
            paths["serve_generic_ndim4"][k] += got[k]
        ref = plain(params, idx, offs)
        label = "zipf1.05" if zipf else "uniform"
        if got != {**zeros, "tt_fwd": 1} or plains:
            fail(f"tt_ndim-4 serve {label}: launches {got}, plain versions "
                 f"{plains}; expected tt_fwd 1 and nothing else")
        if out.shape != (1, B, D) or not torch.isfinite(out).all():
            fail(f"tt_ndim-4 serve {label}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        print(f"[generic4] serve impl='pallas' p={P4} q={Q4} ranks "
              f"{R4[1:-1]} (E={E4}) B={B} pooling {POOL} {label}: max_abs_err "
              f"{err:.3e} vs plain f32, limit {F32_OUT_TOL * scale:.3e} "
              f"({F32_OUT_TOL} x max|out| {scale:.3e}); launches B4 1")
        if not err <= F32_OUT_TOL * scale:
            fail(f"tt_ndim-4 serve {label}: disagrees with the plain path")
    steps = {
        counting: (fbt.make_fused_train_step(
            P4, Q4, R4, 1, B, use_cache=counting, impl="pallas",
            device="cuda"), fbt.make_fused_train_step(
            P4, Q4, R4, 1, B, use_cache=counting, impl="xla",
            precision="highest", device="cuda"))
        for counting in (False, True)}
    prm = params
    for counting in (False, True):
        kstep, pstep = steps[counting]
        if counting:  # hashed: no num_embeddings
            prm = fbt.TTEmbeddingParams(prm.tt_cores, (), fbt.make_cache_state(
                H_WIDE, C_WIDE, D, device="cuda"))
        for zipf, (idx, offs, d_out) in zip((False, True), batches):
            old = clone(prm)
            zero_counts()
            with plain_watch() as plains:
                out, new = kstep(prm, idx, offs, d_out, (LR, EPS))
                torch.cuda.synchronize()
            got = counts()
            for k in wrappers:
                paths["train_generic_ndim4"][k] += got[k]
            ref_out, ref = pstep(clone(old), idx, offs, d_out, (LR, EPS))
            what = (f"tt_ndim-4 step impl='pallas' {'counting ' * counting}"
                    f"{'zipf1.05' if zipf else 'uniform'}")
            if got != {**zeros, "tt_fwd": 1, "tt_bwd": 1} or plains:
                fail(f"{what}: launches {got}, plain versions {plains}; "
                     "expected tt_fwd 1, tt_bwd 1 and nothing else")
            if out.shape != (1, B, D) or not torch.isfinite(out).all():
                fail(f"{what}: bad output {tuple(out.shape)}")
            line = (f"[generic4] {what} SGD B={B} pooling {POOL}: launches "
                    "B4 1 B5 1")
            line = hold_step(line, out, ref_out, new, ref, old, F32_OUT_TOL,
                             F32_UPDATE_TOL, what)
            if counting:
                for f in ("keys", "freq", "slots"):
                    if not torch.equal(getattr(new.cache, f),
                                       getattr(ref.cache, f)):
                        fail(f"{what}: cache {f} differs from the plain "
                             "step's")
                line += (f"; {int(new.cache.freq.long().sum())} lookups "
                         f"counted in {int((new.cache.keys != -1).sum())} of "
                         f"{H_WIDE} slots, keys, counts and slots equal the "
                         "plain step's")
            print(line)
            prm = new
    print(f"[generic4] launches: serve {paths['serve_generic_ndim4']}, "
          f"steps {paths['train_generic_ndim4']} "
          f"({time.perf_counter() - t0:.1f} s)")
    # device ms, operations and host ms per call, uniform batch; the steps
    # on scratch copies at a small learning rate
    idx, offs, d_out = batches[0]
    sgd_scratch = clone(fbt.TTEmbeddingParams(prm.tt_cores, (), None))
    cnt_scratch = clone(prm)
    for label, fn in (
            ("serve", lambda: serve(params, idx, offs)),
            ("SGD step", lambda: steps[False][0](sgd_scratch, idx, offs,
                                                 d_out, (1e-4, EPS))),
            ("counting step", lambda: steps[True][0](
                cnt_scratch, idx, offs, d_out, (1e-4, EPS)))):
        ms, per, mhz = device_ms(fn)
        ops = device_ms.ops
        hms = host_ms(fn)
        kern = " + ".join(f"{kernel_name(k, True)} {v * 1e3:.2f}"
                          for k, v in per.items() if "tt_" in k)
        print(f"[time] tt_ndim-4 {label} impl='pallas' B={B} pooling {POOL} "
              f"uniform: {ms:.4f} ms on the device, {ops:.0f} device "
              f"operations, {hms:.3f} ms host ({hms * 1e3 / (B * POOL):.4f} "
              f"us/lookup); B4/B5 kernels {kern} us; {mhz_text(mhz)} "
              f"[{card}]")
    return paths


def folded_phase(fbt, card, wrappers, params, serve, cache, cserve,
                 request):
    """Phase 4b of the docstring, the folded serve at full width: ``params``
    and the unfolded ``serve`` of phase 4, the populated headline ``cache``
    and its unfolded probing serve ``cserve``; returns the launches of the
    bf16 folded serves and of the int8 ones."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    b1 = {**dict.fromkeys(wrappers, 0), "seg_transform": 1}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def held(label, out, ref, tol, b=B, what="plain f32"):
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"folded {label}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        if not err <= tol * scale:
            fail(f"folded {label}: max_abs_err {err:.3e} vs {what} past "
                 f"{tol} x max|out| {scale:.3e}")
        return (f"max_abs_err {err:.3e} vs {what} (limit {tol} x max|out| "
                f"{scale:.3e})")

    def held_bytes(fp):
        ts = [fp.setup[0], *fp.setup[2]]
        ts += list(fp.setup[1]) if isinstance(fp.setup[1], tuple) else [
            fp.setup[1]]
        if fp.cache is not None:
            ts += [fp.cache.keys, fp.cache.slots, fp.cache.weight]
        if fp.cache_scale is not None:
            ts.append(fp.cache_scale)
        return sum(t.numel() * t.element_size() for t in ts)

    def folded(probe, quantize):
        """(fold, serve, fp, host seconds of the fold)."""
        fold, fserve = fbt.make_folded_serving_fn(
            P, Q, R, 1, B, probe_cache=probe, quantize=quantize,
            device="cuda")
        prm = fbt.TTEmbeddingParams(params.tt_cores, (),
                                    cache if probe else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp = fold(prm)
        torch.cuda.synchronize()
        return fold, fserve, fp, time.perf_counter() - t0

    plain = fbt.make_serving_fn(P, Q, R, 1, B, probe_cache=False,
                                impl="xla", precision="highest",
                                device="cuda")
    cplain = fbt.make_serving_fn(P, Q, R, 1, B, impl="xla",
                                 precision="highest", device="cuda")
    # 1. the folds: bf16 and int8, without and with the populated cache
    folds = {}
    for probe in (False, True):
        for quant in (None, "int8"):
            fold, fserve, fp, sec = folded(probe, quant)
            if fp.setup is None or fp.params is not None:
                fail(f"folded probe_cache={probe} quantize={quant}: the "
                     "fold took its fallback mode")
            tbl = fp.setup[1]
            rows, width = P[0] * P[1] + 1, Q[0] * Q[1] * R[2]
            if quant is None:
                ok = (tbl is not None and tuple(tbl.shape) == (rows, width)
                      and tbl.dtype == torch.bfloat16)
            else:
                ok = (isinstance(tbl, tuple)
                      and tuple(tbl[0].shape) == (rows, width)
                      and tbl[0].dtype == torch.int8
                      and tuple(tbl[1].shape) == (rows,))
            if not ok:
                fail(f"folded quantize={quant}: no pair table of "
                     f"[{rows}, {width}]")
            if probe and (fp.cache is None or (quant == "int8") != (
                    fp.cache.weight.dtype == torch.int8)):
                fail(f"folded probe_cache quantize={quant}: cache not folded")
            folds[probe, quant] = (fold, fserve, fp)
            print(f"[folded] fold probe_cache={probe} quantize={quant}: "
                  f"{sec:.3f} s on the host, holds "
                  f"{held_bytes(fp) / 2**20:.1f} MiB (pair table "
                  f"[{rows}, {width}] "
                  f"{'int8 + float32 scales' if quant else 'bf16'})")
    if folds[True, "int8"][2].cache_scale is None:
        fail("folded int8 with the cache: no cache scales")

    # 2.-3. the folded serves, bf16 then int8, uniform and Zipf(1.05),
    # then (4.) with the populated cache on Zipf traffic; B1 once a request
    reqs = [request(B, z) for z in (False, True)]
    creqs = [request(B, True) for _ in range(2)]
    runs = {}
    launches = {}
    for quant in (None, "int8"):
        outs = []
        zero_counts()
        with plain_watch() as plains:
            for probe, batch in ((False, reqs), (True, creqs)):
                fserve, fp = folds[probe, quant][1:]
                for idx, offs in batch:
                    before = counts()
                    outs.append(fserve(fp, idx, offs))
                    got = {k: v - before[k] for k, v in counts().items()}
                    if got != b1:
                        fail(f"folded quantize={quant}: launches {got} in "
                             "one request, expected B1 once")
            torch.cuda.synchronize()
        launches[quant] = counts()
        if plains:
            fail(f"folded quantize={quant}: plain versions ran on the card: "
                 f"{plains}")
        runs[quant] = outs
    for i, ((idx, offs), out) in enumerate(zip(reqs + creqs, runs[None])):
        cached = i >= len(reqs)
        label = (f"B={B} pooling {POOL} "
                 f"{'zipf1.05' if i % 2 or cached else 'uniform'}"
                 + (" probe_cache" if cached else ""))
        line = held(label, out, (cplain if cached else plain)(
            fbt.TTEmbeddingParams(params.tt_cores, (), cache) if cached
            else params, idx, offs), OUT_TOL)
        unf = (cserve(fbt.TTEmbeddingParams(params.tt_cores, (), cache),
                      idx, offs) if cached else serve(params, idx, offs))
        line += "; " + held(label, out, unf, OUT_TOL,
                            what="the unfolded serve")
        q_line = held(label, runs["int8"][i], out, 1e-2,
                      what="the bf16 fold")
        print(f"[folded] {label}: bf16 fold {line}; int8 fold {q_line}; "
              "launches B1 1 each, plain versions 0")
    # the int8 pair table's rounding, against the bf16 table's row absmax
    tbl = folds[False, None][2].setup[1].float()
    q8, qs = folds[False, "int8"][2].setup[1]
    amax = tbl.abs().amax(dim=1).clamp(min=1e-30)
    rel = ((q8.float() * qs[:, None] - tbl).abs().amax(dim=1) / amax).max()
    print(f"[folded] int8 pair table: max over rows of max|dequant - bf16| "
          f"/ row absmax = {rel.item():.4e} (half a step: "
          f"{0.5 / 127:.4e})")

    # 4. refold_cache after one more populate, against a fresh fold
    newer = clone_cache(cache)
    fbt.update_cache_state(newer, request(B, True)[0])
    newer = fbt.cache_populate(newer, params.tt_cores, P, Q, R)
    prm2 = fbt.TTEmbeddingParams(params.tt_cores, (), newer)
    for quant in (None, "int8"):
        fold, fserve, fp = folds[True, quant]
        re_fp = fbt.refold_cache(fp, prm2)
        fresh = fold(prm2)
        if re_fp.setup is not fp.setup:
            fail(f"refold_cache quantize={quant}: the tables were rebuilt")
        for idx, offs in creqs:
            a, b_ = fserve(re_fp, idx, offs), fserve(fresh, idx, offs)
            if not torch.equal(a, b_):
                fail(f"refold_cache quantize={quant}: differs from a fresh "
                     "fold")
        print(f"[folded] refold_cache quantize={quant} after one more "
              f"populate: equal to a fresh fold bitwise on "
              f"{len(creqs)} Zipf requests")
    del newer, prm2, re_fp, fresh

    # 5. the bucketed front-end: four odd requests, each against the
    # unfolded serve on its exact shape
    bfold, bserve = fbt.make_bucketed_serving_fn(
        P, Q, R, 1, batch_buckets=[64, B], nnz_buckets=[2048, B * POOL],
        probe_cache=False, device="cuda")
    bfp = bfold(params)
    brng = np.random.default_rng(4)
    breqs = [(bq, lq, brng.integers(0, E, size=bq * lq),
              np.arange(0, bq * lq + 1, lq))
             for bq, lq in ((5, 7), (61, 33), (300, 9), (B, POOL))]
    zero_counts()
    bouts = []
    with plain_watch() as plains:
        for _, _, idx, offs in breqs:
            bouts.append(bserve(bfp, idx, offs))
        torch.cuda.synchronize()
    if plains or counts()["seg_transform"] != len(breqs):
        fail(f"bucketed: launches {counts()}, plain versions {plains}")
    for k in wrappers:
        launches[None][k] += counts()[k]
    for (bq, lq, idx, offs), out in zip(breqs, bouts):
        exact = fbt.make_serving_fn(P, Q, R, 1, bq, probe_cache=False,
                                    device="cuda")
        line = held(f"bucketed B={bq} nnz {bq * lq}", out,
                    exact(params, idx, offs), OUT_TOL, b=bq,
                    what="make_serving_fn on the exact shape")
        print(f"[folded] bucketed B={bq} nnz {bq * lq}: {line}; B1 1")

    # 6. the module: freeze_for_serving against the module's forward
    emb = fbt.TTEmbeddingBag(E, D, R[1:-1], tt_p_shapes=P, tt_q_shapes=Q,
                             seed=0, device="cuda")
    for z in (True, False, True):
        emb(*request(B, z))
    emb.cache_populate()
    mfp, mserve = emb.freeze_for_serving(B)
    midx, moffs = request(B, True)
    zero_counts()
    with plain_watch() as plains:
        mout = mserve(mfp, midx, moffs)
        torch.cuda.synchronize()
    if plains or counts() != b1 or mfp.setup is None or mfp.cache is None:
        fail(f"module freeze_for_serving: launches {counts()}, plain "
             f"versions {plains}, flat mode {mfp.setup is not None}")
    for k in wrappers:
        launches[None][k] += counts()[k]
    line = held(f"module B={B} zipf1.05", mout, emb(midx, moffs,
                                                    warmup=False)[None],
                OUT_TOL, what="the module's forward")
    print(f"[folded] TTEmbeddingBag.freeze_for_serving(B={B}) with its "
          f"populated cache, hit rate {emb.cache_hit_rate():.4f}: {line}; "
          "launches B1 1, plain versions 0")
    del emb, mfp

    # 7. times per request, in turns: unfolded, bf16 fold, int8 fold, then
    # the other way round
    fp16, fpq = folds[False, None][2], folds[False, "int8"][2]
    s16, sq = folds[False, None][1], folds[False, "int8"][1]
    for label, (idx, offs) in zip(("uniform", "zipf1.05"), reqs):
        calls = {"unfolded": lambda: serve(params, idx, offs),
                 "folded": lambda: s16(fp16, idx, offs),
                 "folded int8": lambda: sq(fpq, idx, offs)}
        got = {k: [] for k in calls}
        for name in ("unfolded", "folded", "folded int8", "folded int8",
                     "folded", "unfolded"):
            dev, _, mhz = device_ms(calls[name])
            got[name].append((dev, device_ms.ops, host_ms(calls[name]), mhz))
        for name, rs in got.items():
            print(f"[time] serve {name} B={B} pooling {POOL} {label}: "
                  + " / ".join(f"device {d:.4f} ms, host {h:.3f} ms, "
                               f"{o:.1f} device ops" for d, o, h, _ in rs)
                  + f" per request ({mhz_text(rs[-1][3])}) [{card}]")
    print(f"[folded] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"launches bf16 {launches[None]}, int8 {launches['int8']}")
    return launches[None], launches["int8"]


def launch_text(c):
    """Nonzero launch counts as ``B1 n B2 n ...``."""
    names = ("B1", "B2", "B3", "B4", "B5", "B6")
    return " ".join(f"{n} {c[k]}" for n, k in zip(names, (
        "seg_transform", "seg_fused_i2", "seg_accum", "tt_fwd", "tt_bwd",
        "seg_accum_dg0")) if c[k])


def module_call(fbt, wrappers, launches, m, r, bt, fwd_want, bwd_want,
                label, tols=(OUT_TOL, UPDATE_TOL), tag="module"):
    """One forward + backward of module ``m`` and of the plain module
    ``r`` loaded with the same state; launches (forward, backward, added
    to ``launches``) and no plain kernel version checked, then the output,
    the update (or the dense gradients) and the cache against the plain
    module's; the line printed starts with ``[tag]``."""
    import torch

    from fbtt_embedding_tpu_torch.ops.cache import CacheState

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    idx, offs, d_out = bt
    old = {k: v.clone() for k, v in m.state_dict().items()}
    r.load_state_dict(old)
    r.warmup = m.warmup
    for fn in wrappers.values():
        fn.launches = 0
    with plain_watch() as plains:
        out = m(idx, offs)
        torch.cuda.synchronize()
        fwd = counts()
        res = m.backward(d_out)
        torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in counts().items()}
    for k in wrappers:
        launches[k] += fwd[k] + bwd[k]
    if plains:
        fail(f"module {label}: plain versions ran on the card: {plains}")
    if fwd != fwd_want or bwd != bwd_want:
        fail(f"module {label}: launches forward {fwd}, backward {bwd}; "
             f"expected {fwd_want}, {bwd_want}")
    hit = m.cache_hit_rate()
    ref_out = r(idx, offs)
    ref_res = r.backward(d_out)
    b_ = offs.shape[0] - 1
    if out.shape[-2:] != (b_ // m.num_tables, D) \
            or not torch.isfinite(out).all():
        fail(f"module {label}: bad output {tuple(out.shape)}")
    line = (f"[{tag}] {label}: hit rate {hit:.4f}; launches forward "
            f"{launch_text(fwd)}, backward {launch_text(bwd)}, plain "
            "versions 0")
    old_p = fbt.TTEmbeddingParams(tuple(
        old[f"tt_cores.{i}"] for i in range(m.tt_ndim)))
    if res is None:  # sparse: the cores (and cache rows) updated
        line = hold_step(line, out, ref_out, m.params, r.params, old_p,
                         *tols, f"module {label}")
    else:  # dense: the gradients against the plain module's
        scale = ref_out.abs().max().item()
        err = (out - ref_out).abs().max().item()
        line += (f"; output max_abs_err {err:.3e} (limit {tols[0]} x "
                 f"{scale:.3e})")
        if not err <= tols[0] * scale:
            fail(f"module {label}: output disagrees with the plain one")
        for t, (g, g_ref) in enumerate(zip(res[0], ref_res[0])):
            big = g_ref.abs().max().item()
            gerr = (g - g_ref).abs().max().item()
            line += (f"; d_core {t} max_abs_err {gerr:.3e} (limit "
                     f"{tols[1]} x {big:.3e})")
            if not (torch.isfinite(g).all() and gerr <= tols[1] * big):
                fail(f"module {label}: d_core {t} disagrees")
        dc, dc_ref = res[1], ref_res[1]
        big = dc_ref.abs().max().item()
        cerr = (dc - dc_ref).abs().max().item()
        line += (f"; d_cache_weight max_abs_err {cerr:.3e} (limit 1e-6 "
                 f"x {big:.3e})")
        if not (big > 0 and cerr <= 1e-6 * big):
            fail(f"module {label}: d_cache_weight disagrees")
    if m.cache is not None and not m.warmup and res is None:
        old_c = CacheState(*(old[f"cache.{f}"] for f in (
            "keys", "freq", "slots", "weight", "opt_state")))
        line = hold_cache(line, m.params.cache, r.params.cache, old_c,
                          f"module {label}")
    print(line)
    return out


def module_phase(fbt, card, wrappers, request, fused_step):
    """Phase 5b of the docstring, the modules at full width; returns the
    launches of the module calls."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.ops.kernels import tt_flat

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def want(**kw):
        return want_launches(wrappers, **kw)

    text = launch_text

    t_phase = time.perf_counter()
    rng = np.random.default_rng(3)
    kw = dict(tt_p_shapes=P, tt_q_shapes=Q, seed=0, learning_rate=LR,
              eps=EPS, device="cuda")
    plain = dict(impl="xla", precision="highest")
    mod = fbt.TTEmbeddingBag(E, D, R[1:-1], **kw)
    ref = fbt.TTEmbeddingBag(E, D, R[1:-1], **kw, **plain)
    launches = dict.fromkeys(wrappers, 0)

    def batch(zipf, tables=1):
        idx, offs = request(tables * B, zipf)
        d_out = torch.as_tensor(rng.standard_normal((tables, B, D)),
                                dtype=torch.float32, device="cuda")
        return idx, offs, d_out

    def checked(*args, **kw):
        return module_call(fbt, wrappers, launches, *args, **kw)

    # warm-up: forward + sparse SGD backward, counting every id
    two = want(B1=2)
    b3x2 = want(B3=2)
    warm = [batch(z) for z in (False, True, False, True)]
    for i, bt in enumerate(warm):
        checked(mod, ref, bt, two, b3x2,
                f"TTEmbeddingBag SGD B={B} pooling {POOL} "
                f"{'zipf1.05' if i % 2 else 'uniform'} warm-up call {i}")
    want_freq = torch.bincount(torch.cat([bt[0] for bt in warm]),
                               minlength=E)
    if not torch.equal(mod.cache.freq.long(), want_freq):
        fail("module: LFU counts differ from torch.bincount")
    print(f"[module] LFU counts after {len(warm)} warm-up calls equal "
          f"torch.bincount of the traffic ({int(want_freq.sum())} lookups; "
          f"direct mode, hashtbl_size {mod.cache.freq.shape[0]}, cache_size "
          f"{mod.cache.weight.shape[0]})")
    t0 = time.perf_counter()
    mod.cache_populate()
    torch.cuda.synchronize()
    print(f"[module] cache_populate: {int((mod.cache.slots >= 0).sum())} "
          f"rows in {time.perf_counter() - t0:.2f} s, warmup {mod.warmup}")
    for i in range(2):
        checked(mod, ref, batch(True), two, b3x2,
                f"TTEmbeddingBag SGD B={B} zipf1.05 probed call {i}")

    # EXACT_ADAGRAD on the populated cache (full [C, D] cache state), from
    # zero state. (a) float32 staging (B1 and B3 on their float32 paths)
    # against the plain module at the float32 limits
    ada = fbt.OptimType.EXACT_ADAGRAD
    amod = fbt.TTEmbeddingBag(E, D, R[1:-1], optimizer=ada,
                              precision="highest", **kw)
    aref = fbt.TTEmbeddingBag(E, D, R[1:-1], optimizer=ada, **kw, **plain)
    state = {k: v.clone() for k, v in mod.state_dict().items()}
    for i, c in enumerate(mod.tt_cores):
        state[f"optimizer_state.{i}"] = torch.zeros_like(c)
    state["cache.opt_state"] = torch.zeros_like(mod.cache.weight)
    amod.load_state_dict(state)
    amod.warmup = False
    abt = batch(True)
    checked(amod, aref, abt, two, b3x2,
            f"TTEmbeddingBag EXACT_ADAGRAD precision='highest' B={B} "
            "zipf1.05 probed", (F32_OUT_TOL, F32_UPDATE_TOL))
    # (b) bfloat16 staging. Adagrad's first step divides each element by
    # |g| + eps, which lifts the staging error of an element with a small
    # gradient to the size of the whole update, so it is not held to the
    # SGD steps' limit against the plain step; the module's update is held
    # to that limit against the fused step's on the same state and batch
    # (the same staging), and both are printed against the plain one
    # (``aref`` after (a))
    del amod
    bmod = fbt.TTEmbeddingBag(E, D, R[1:-1], optimizer=ada, **kw)
    bmod.load_state_dict(state)
    bmod.warmup = False
    zero_counts()
    with plain_watch() as plains:
        bmod(*abt[:2])
        bmod.backward(abt[2])
        torch.cuda.synchronize()
    got = counts()
    for k in wrappers:
        launches[k] += got[k]
    if plains or got != want(B1=2, B3=2):
        fail(f"module EXACT_ADAGRAD bf16: launches {got}, plain {plains}")
    fstep = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                      use_cache=True, probe_cache=True,
                                      device="cuda")
    _, fused_new = fstep(fbt.params_from_state_dict(state, 3, True, "cuda"),
                         *abt, (LR, EPS))
    line = f"[module] TTEmbeddingBag EXACT_ADAGRAD B={B} zipf1.05 probed, bf16"
    for t in range(len(P)):
        o = state[f"tt_cores.{t}"]
        d_mod = bmod.tt_cores[t].detach() - o
        d_fused = fused_new.tt_cores[t] - o
        d_plain = aref.tt_cores[t].detach() - o

        def rel(a, b_):
            return ((a - b_).abs().max() / b_.abs().max()).item()

        r_mf, r_mp, r_fp = (rel(d_mod, d_fused), rel(d_mod, d_plain),
                            rel(d_fused, d_plain))
        line += (f"; core {t} max|dcore - dcore_fused| / max|dcore_fused| "
                 f"{r_mf:.4f} (limit {UPDATE_TOL}), against the plain "
                 f"module: this {r_mp:.4f}, the fused step {r_fp:.4f}")
        if not (torch.isfinite(d_mod).all() and r_mf <= UPDATE_TOL):
            fail(f"module EXACT_ADAGRAD bf16: core {t} update disagrees with "
                 "the fused step's")
    print(line)
    del bmod, aref, state, fused_new

    # FBTT_DG0=fused: B6 takes the i1 pass from B3
    with knob({"FBTT_DG0": "fused"}):
        checked(mod, ref, batch(True), two, want(B3=1, B6=1),
                f"TTEmbeddingBag SGD B={B} zipf1.05 probed, FBTT_DG0=fused")

    # impl="pallas": B4 forward, B5 backward, float32 (live lookups first)
    pmod = fbt.TTEmbeddingBag(E, D, R[1:-1], impl="pallas", **kw)
    pmod.load_state_dict(mod.state_dict())
    pmod.warmup = False
    checked(pmod, ref, batch(True), want(B4=1), want(B5=1),
            f"TTEmbeddingBag impl='pallas' SGD B={B} zipf1.05 probed",
            (F32_OUT_TOL, F32_UPDATE_TOL))
    del pmod

    # sparse=False: backward returns the core gradients and d_cache_weight
    dmod = fbt.TTEmbeddingBag(E, D, R[1:-1], sparse=False, **kw)
    dref = fbt.TTEmbeddingBag(E, D, R[1:-1], sparse=False, **kw, **plain)
    dmod.load_state_dict(mod.state_dict())
    dmod.warmup = False
    checked(dmod, dref, batch(True), two, b3x2,
            f"TTEmbeddingBag sparse=False B={B} zipf1.05 probed")
    del dmod, dref

    # two tables at the same widths, forward + SGD
    tmod = fbt.TableBatchedTTEmbeddingBag(2, E, D, R[1:-1], **kw)
    tref = fbt.TableBatchedTTEmbeddingBag(2, E, D, R[1:-1], **kw, **plain)
    tbt = batch(False, tables=2)
    nza = -(-tbt[0].shape[0] // tt_flat.SEG) * tt_flat.SEG
    pair = tt_flat._pair_gate(nza, 2, tuple(P), tuple(Q), tuple(R), 2)
    checked(tmod, tref, tbt, want(B1=1 if pair else 2), b3x2,
            f"TableBatchedTTEmbeddingBag T=2 SGD B={B} pooling {POOL} "
            f"uniform ({'pair mode' if pair else 'two-pass'})")
    del tmod, tref

    # full_weight at E' = 11M against single-id bags of the forward
    t0 = time.perf_counter()
    w = mod.full_weight()
    torch.cuda.synchronize()
    w_s = time.perf_counter() - t0
    ids = torch.as_tensor(np.concatenate([[0, E - 1], rng.integers(
        0, E, 510)]), device="cuda")
    offs = torch.arange(ids.shape[0] + 1, device="cuda")
    ref.load_state_dict(mod.state_dict())
    with torch.no_grad():
        zero_counts()
        rows = mod(ids, offs, warmup=True)
        fwd = counts()
        ref_rows = ref(ids, offs, warmup=True)
    want_rows = w[ids.long()]
    scale = want_rows.abs().max().item()
    err = (rows - want_rows).abs().max().item()
    perr = (ref_rows - want_rows).abs().max().item()
    for k in wrappers:
        launches[k] += fwd[k]
    print(f"[module] full_weight {tuple(w.shape)} float32 in {w_s:.3f} s; "
          f"{ids.shape[0]} sampled rows against single-id bags: the module's "
          f"forward ({text(fwd)}) max_abs_err {err:.3e} (limit {OUT_TOL} x "
          f"{scale:.3e}), the plain module's {perr:.3e} (limit "
          f"{F32_OUT_TOL} x {scale:.3e})")
    if w.shape != (E, D) or not (fwd["seg_transform"] > 0
                                 and err <= OUT_TOL * scale
                                 and perr <= F32_OUT_TOL * scale):
        fail("module: full_weight rows disagree with the forward")
    del w, want_rows
    torch.cuda.empty_cache()

    # import_full_weight round trip on a 110k-row model (p=[20, 22, 250];
    # the TT-SVD of the 11M-row table is seconds of host LAPACK)
    small_p = [20, 22, 250]
    e_small = 20 * 22 * 250
    small = fbt.TTEmbeddingBag(e_small, D, R[1:-1], tt_p_shapes=small_p,
                               tt_q_shapes=Q, seed=0, device="cuda")
    ws = small.full_weight()
    fresh = fbt.TTEmbeddingBag(e_small, D, R[1:-1], tt_p_shapes=small_p,
                               tt_q_shapes=Q, seed=1, device="cuda")
    t0 = time.perf_counter()
    fresh.import_full_weight(ws)
    svd_s = time.perf_counter() - t0
    scale = ws.abs().max().item()
    err = (fresh.full_weight() - ws).abs().max().item()
    print(f"[module] import_full_weight round trip E={e_small} "
          f"(p={small.tt_p_shapes}): TT-SVD {svd_s:.2f} s on the host, "
          f"full_weight max_abs_err {err:.3e} (limit 1e-4 x {scale:.3e})")
    if not err <= 1e-4 * scale:
        fail("module: import_full_weight does not round-trip")
    del small, fresh, ws

    # host clock: the module's forward and forward + backward (counting,
    # no probe) beside the fused counting step, in turns
    tmod = fbt.TTEmbeddingBag(E, D, R[1:-1], tt_p_shapes=P, tt_q_shapes=Q,
                              seed=0, learning_rate=1e-4, device="cuda")
    fprm = fbt.TTEmbeddingParams(
        tuple(c.detach().clone() for c in tmod.tt_cores), (),
        fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                             device="cuda"))
    idx, offs, d_out = batch(False)

    def fwd_only():
        with torch.no_grad():
            tmod(idx, offs)

    def fwd_bwd():
        tmod(idx, offs)
        tmod.backward(d_out)

    def fused():
        fused_step(fprm, idx, offs, d_out, (1e-4, EPS))

    ms = {"forward": [], "forward + backward": [], "fused step": []}
    for order in (("forward", "forward + backward", "fused step"),
                  ("fused step", "forward + backward", "forward")):
        for name in order:
            fn = {"forward": fwd_only, "forward + backward": fwd_bwd,
                  "fused step": fused}[name]
            ms[name].append(host_ms(fn))
    dev = {name: device_ms(fn)[0] for name, fn in (
        ("forward + backward", fwd_bwd), ("fused step", fused))}
    print(f"[time] module B={B} pooling {POOL} uniform, LFU counting on (no "
          "probe), host-clock medians of 25, in turns: "
          + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} ms" for k, v in
                      ms.items())
          + "; device time per call: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in dev.items())
          + f" (the fused counting step, make_fused_train_step: B1 1, B2 1, "
          f"B3 1; the module: B1 2 forward, B3 2 backward) [{card}]")
    print(f"[module] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}")
    return launches


def want_launches(wrappers, **kw):
    """Launch counts by wrapper: ``B1=1, B3=2, ...`` given, 0 elsewhere."""
    short = {"B1": "seg_transform", "B2": "seg_fused_i2", "B3": "seg_accum",
             "B4": "tt_fwd", "B5": "tt_bwd", "B6": "seg_accum_dg0"}
    return {**dict.fromkeys(wrappers, 0),
            **{short[k]: v for k, v in kw.items()}}


def clone_params(fbt, prm):
    """A copy of the cores, the optimizer state and the cache."""
    return fbt.TTEmbeddingParams(
        tuple(c.clone() for c in prm.tt_cores),
        tuple(s.clone() for s in prm.optimizer_state),
        clone_cache(prm.cache) if prm.cache is not None else None)


def hold_state(line, new, ref, old, tol, what):
    """Hold the optimizer state after a step against the plain step's: an
    integer entry (the step counter) exactly, a float one's change within
    ``tol`` of the plain change's largest element; returns ``line``."""
    import torch

    worst = 0.0
    for i, (s_new, s_ref, s_old) in enumerate(zip(new, ref, old)):
        if not s_new.is_floating_point():
            if not torch.equal(s_new, s_ref):
                fail(f"{what}: state {i} {s_new.tolist()} differs from the "
                     f"plain step's {s_ref.tolist()}")
            continue
        if not s_new.numel():
            continue
        upd = (s_ref - s_old).abs().max().item()
        err = (s_new - s_ref).abs().max().item()
        if not (torch.isfinite(s_new).all() and upd > 0
                and err <= tol * upd):
            fail(f"{what}: optimizer state {i} disagrees with the plain "
                 f"step's ({err:.3e} against {upd:.3e})")
        worst = max(worst, err / upd)
    return line + (f"; optimizer state ({len(new)} entries) max|d - d_plain|"
                   f" / max|d_plain| {worst:.3e} (limit {tol})")


def hold_cosine(line, new, ref, old, what):
    """bf16 staging: each core's update against the plain step's by their
    cosine (>= 0.99, every value finite), the max relative error printed
    beside it; returns ``line``."""
    import torch

    for t, (c_new, c_ref, c_old) in enumerate(zip(new.tt_cores, ref.tt_cores,
                                                  old.tt_cores)):
        d, d_ref = (c_new - c_old).flatten(), (c_ref - c_old).flatten()
        cos = torch.nn.functional.cosine_similarity(d, d_ref, dim=0).item()
        rel = ((d - d_ref).abs().max() / d_ref.abs().max()).item()
        line += (f"; core {t} cos(dcore, dcore_plain) {cos:.5f} (limit "
                 f"{COS_MIN}), max|dcore - dcore_plain| / max|dcore_plain| "
                 f"{rel:.4f}")
        if not (torch.isfinite(c_new).all() and cos >= COS_MIN):
            fail(f"{what}: core {t} update disagrees with the plain step")
    return line


def native_wide_phase(fbt, card, wrappers, request, cores, cache,
                      count_step):
    """Phase 5c of the docstring: the native optimizers at the headline and
    the wide-key cache on a table past 2^31 rows; returns the launches of
    the paths ``train_native``, ``train_wide_cache``, ``serve_wide_cache``
    and ``module_wide_cache``."""
    import numpy as np
    import torch

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def want(**kw):
        return want_launches(wrappers, **kw)

    t_phase = time.perf_counter()
    rng = np.random.default_rng(6)
    paths = {k: dict.fromkeys(wrappers, 0) for k in (
        "train_native", "train_wide_cache", "serve_wide_cache",
        "module_wide_cache")}
    plain = dict(impl="xla", precision="highest")
    flat3 = want(B1=1, B2=1, B3=1)

    def d_out(b=B):
        return torch.as_tensor(rng.standard_normal((1, b, D)),
                               dtype=torch.float32, device="cuda")

    def stepped(path, kstep, pstep, prm, batch, expect, label):
        """One kernel step on ``prm`` (launches checked, no plain version)
        and the plain step on a copy of the same params: ``(out, new,
        ref_out, ref, old)``."""
        old = clone_params(fbt, prm)
        zero_counts()
        with plain_watch() as plains:
            out, new = kstep(prm, *batch, (LR, EPS))
            torch.cuda.synchronize()
        got = counts()
        for k in wrappers:
            paths[path][k] += got[k]
        if plains or got != expect:
            fail(f"{label}: launches {got} (expected {expect}), plain "
                 f"versions {plains}")
        ref_out, ref = pstep(clone_params(fbt, old), *batch, (LR, EPS))
        b_ = batch[1].shape[0] - 1
        if out.shape != (1, b_, D) or not torch.isfinite(out).all():
            fail(f"{label}: bad output {tuple(out.shape)}")
        return out, new, ref_out, ref, old

    # (a) the native optimizers at the headline, counting on (direct mode),
    # three steps each: float32 staging at the float32 limits, bf16 staging
    # by the cosine of the core updates
    nbatches = [request(B, z) + (d_out(),) for z in (False, True, False)]
    tparams = fbt.params_from_jax(cores, device="cuda")

    def native_params(optim, cached=True):
        """The headline cores, zero native state and (``cached``) an empty
        direct-mode cache at the reference benchmark's sizes."""
        return fbt.TTEmbeddingParams(
            tuple(c.clone() for c in tparams.tt_cores),
            fbt.native_optim_init(optim, tparams.tt_cores),
            fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                                 device="cuda") if cached else None)

    def native_step(optim, **kw):
        return fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=optim,
                                         optim_semantics="native",
                                         device="cuda", **kw)

    for name in NATIVE_OPTIMS:
        optim = getattr(fbt.OptimType, name)
        pstep = native_step(optim, use_cache=True, **plain)
        for staging, extra in (("float32", dict(precision="highest")),
                               ("bf16", {})):
            kstep = native_step(optim, use_cache=True, **extra)
            prm = native_params(optim)
            for i, batch in enumerate(nbatches):
                label = (f"native {name} {staging} B={B} pooling {POOL} "
                         f"{'zipf1.05' if i % 2 else 'uniform'} counting "
                         f"step {i}")
                out, new, ref_out, ref, old = stepped(
                    "train_native", kstep, pstep, prm, batch, flat3, label)
                line = f"[native+wide] {label}: launches B1 1 B2 1 B3 1"
                if staging == "float32":
                    line = hold_step(line, out, ref_out, new, ref, old,
                                     F32_OUT_TOL, F32_UPDATE_TOL, label,
                                     store_ulp=True)
                    line = hold_state(line, new.optimizer_state,
                                      ref.optimizer_state,
                                      old.optimizer_state, F32_UPDATE_TOL,
                                      label)
                else:
                    scale = ref_out.abs().max().item()
                    err = (out - ref_out).abs().max().item()
                    line += (f"; output max_abs_err {err:.3e} (limit "
                             f"{OUT_TOL} x {scale:.3e})")
                    if not err <= OUT_TOL * scale:
                        fail(f"{label}: output disagrees with the plain "
                             "step")
                    line = hold_cosine(line, new, ref, old, label)
                if not torch.equal(new.cache.freq, ref.cache.freq):
                    fail(f"{label}: LFU counts differ from the plain step's")
                print(line + "; LFU counts equal the plain step's")
                prm = new
            if name in NATIVE_MOMENTS:
                steps = int(prm.optimizer_state[-1])
                if steps != len(nbatches) \
                        or prm.optimizer_state[-1].dtype != torch.int32:
                    fail(f"native {name}: step counter {steps}, expected "
                         f"{len(nbatches)} (int32)")
            del prm, new, ref, old

    # native SGD and EXACT_ADAGRAD equal the reference semantics bitwise
    for name in ("SGD", "EXACT_ADAGRAD"):
        optim = getattr(fbt.OptimType, name)
        runs = []
        for semantics in ("reference", "native"):
            prm = native_params(optim)
            step = fbt.make_fused_train_step(
                P, Q, R, 1, B, optimizer=optim, use_cache=True,
                optim_semantics=semantics, device="cuda")
            for batch in nbatches[:2]:
                zero_counts()
                out, prm = step(prm, *batch, (LR, EPS))
                if semantics == "native":
                    for k in wrappers:
                        paths["train_native"][k] += counts()[k]
            runs.append([out, *prm.tt_cores, *prm.optimizer_state,
                         prm.cache.freq])
        if not all(torch.equal(a, b_) for a, b_ in zip(*runs)):
            fail(f"native {name}: differs from the reference semantics")
        print(f"[native+wide] native {name}: two counting steps bitwise equal "
              "to the reference semantics' (output, cores, state, counts)")
        del runs, prm

    # one native ADAM step on the generic kernels (B4, B5; float32) and one
    # under FBTT_DG0=fused (B6 takes B3's i1 pass)
    adam = fbt.OptimType.ADAM
    batch = nbatches[1]
    prm = native_params(adam, cached=False)
    label = f"native ADAM impl='pallas' B={B} zipf1.05"
    out, new, ref_out, ref, old = stepped(
        "train_native", native_step(adam, impl="pallas"), native_step(
            adam, **plain), prm, batch, want(B4=1, B5=1), label)
    line = hold_step(f"[native+wide] {label}: launches B4 1 B5 1", out,
                     ref_out, new, ref, old, F32_OUT_TOL, F32_UPDATE_TOL,
                     label, store_ulp=True)
    print(hold_state(line, new.optimizer_state, ref.optimizer_state,
                     old.optimizer_state, F32_UPDATE_TOL, label))
    with knob({"FBTT_DG0": "fused"}):
        prm = native_params(adam, cached=False)
        label = f"native ADAM FBTT_DG0=fused B={B} zipf1.05 bf16"
        out, new, ref_out, ref, old = stepped(
            "train_native", native_step(adam), native_step(adam, **plain),
            prm, batch, want(B1=1, B2=1, B6=1), label)
        print(hold_cosine(f"[native+wide] {label}: launches B1 1 B2 1 B6 1",
                          new, ref, old, label))

    # one native LAMB step probing the populated headline cache: the cores
    # by LAMB, the cache rows by row-wise Adagrad ([C] state)
    lamb = fbt.OptimType.LAMB
    c = clone_cache(cache)
    c.opt_state = torch.zeros(c.cache_size, device="cuda")
    prm = fbt.TTEmbeddingParams(tuple(c_.clone() for c_ in tparams.tt_cores),
                                fbt.native_optim_init(lamb,
                                                      tparams.tt_cores), c)
    zb = request(B, True) + (d_out(),)
    hit = (fbt.cache_lookup(cache, zb[0]) >= 0).float().mean().item()
    label = f"native LAMB B={B} zipf1.05 cached (hit rate {hit:.4f}) bf16"
    kw = dict(use_cache=True, probe_cache=True)
    out, new, ref_out, ref, old = stepped(
        "train_native", native_step(lamb, **kw),
        native_step(lamb, **kw, **plain), prm, zb, flat3, label)
    line = hold_cosine(f"[native+wide] {label}: launches B1 1 B2 1 B3 1",
                       new, ref, old, label)
    print(hold_cache(line, new.cache, ref.cache, old.cache, label))
    del prm, new, ref, old, c
    torch.cuda.empty_cache()

    # (b) the wide-key cache: p = [1300, 1300, 1300] (E past 2^31) at the
    # headline widths, hashtbl_size 2^24, cache_size 2^20
    wcores = fbt.init_tt_cores(np.random.default_rng(4), "uniform", 1, E_WIDE,
                               D, P_WIDE, Q, R)
    wparams = fbt.params_from_jax(wcores, device="cuda")
    wparams.cache = fbt.make_cache_state(H_WIDE, C_WIDE, D, wide_keys=3,
                                         device="cuda")
    mb = sum(getattr(wparams.cache, f).numel() * 4 for f in (
        "keys", "freq", "slots", "weight")) / 1e6
    wrng = np.random.default_rng(5)

    def wide_ids(n):
        """Zipf(1.05) ranks spread over [0, E): three in four onto ids at
        2^31 or above, the others below; id -1 at 1%."""
        r = (wrng.zipf(1.05, size=n) - 1) % (1 << 40)
        mixed = r * WIDE_MULT
        ids = np.where(r % 4 != 3, 2 ** 31 + mixed % (E_WIDE - 2 ** 31),
                       mixed % 2 ** 31)
        ids[wrng.random(n) < 0.01] = -1
        return ids.astype(np.int64)

    def wide_batch(b=B):
        """Wide key rows of ``wide_ids``, 1% of them pads (hi, lo) = -1
        with parts 0 (the bucketed front-end's pad), with offsets and
        d_output; the host rows too."""
        n = b * POOL
        rows = fbt.wide_keyrows(wide_ids(n), P_WIDE)
        rows[wrng.random(n) < 0.01] = (-1, -1, 0, 0, 0)
        return (torch.as_tensor(rows, device="cuda"),
                torch.arange(0, n + 1, POOL, device="cuda"), d_out(b)), rows

    wcount = fbt.make_fused_train_step(P_WIDE, Q, R, 1, B, use_cache=True,
                                       device="cuda")
    host_rows = []
    t0 = time.perf_counter()
    for i in range(20):
        batch, rows = wide_batch()
        host_rows.append(rows)
        zero_counts()
        with plain_watch() as plains:
            out, wparams = wcount(wparams, *batch, (1e-4, EPS))
            torch.cuda.synchronize()
        got = counts()
        for k in wrappers:
            paths["train_wide_cache"][k] += got[k]
        if plains or got != flat3 or not torch.isfinite(out).all():
            fail(f"wide counting step {i}: launches {got}, plain versions "
                 f"{plains}, finite {bool(torch.isfinite(out).all())}")
    count_s = time.perf_counter() - t0
    # each distinct valid id within MAX_PROBES of its hash, its key row
    # (hi, lo, parts) and count exact; pads counted nowhere
    allrows = np.concatenate(host_rows)
    valid = allrows[allrows[:, 0] >= 0]
    ids64 = (valid[:, 0].astype(np.int64) << 31) | valid[:, 1]
    uniq, first, cnt = np.unique(ids64, return_index=True,
                                 return_counts=True)
    urows = valid[first]
    if not all(np.array_equal(urows[:, 2 + t], part) for t, part in
               enumerate(fbt.decompose_indices64(uniq, P_WIDE))):
        fail("wide key rows: part columns differ from decompose_indices64")
    wc = wparams.cache
    hi = torch.as_tensor(urows[:, 0], device="cuda")
    lo = torch.as_tensor(urows[:, 1], device="cuda")
    h = fbt.hash_keys_wide(hi, lo, H_WIDE).long()
    slot = torch.full_like(h, -1)
    for j in range(3):  # MAX_PROBES
        s_ = (h + j) % H_WIDE
        k_ = wc.keys[s_]
        slot = torch.where((slot < 0) & (k_[:, 0] == hi) & (k_[:, 1] == lo),
                           s_, slot)
    if not bool((slot >= 0).all()):
        fail(f"wide counting: {int((slot < 0).sum())} of {len(uniq)} ids "
             "not within MAX_PROBES of their hash")
    if not (torch.equal(wc.keys[slot].cpu(), torch.as_tensor(urows))
            and torch.equal(wc.freq[slot].cpu(),
                            torch.as_tensor(cnt, dtype=torch.int32))):
        fail("wide counting: a key row or count differs from the host's")
    occupied = int((wc.keys[:, 0] != -1).sum())
    total = int(wc.freq.long().sum())
    if occupied != len(uniq) or total != len(valid):
        fail(f"wide counting: {occupied} occupied slots for {len(uniq)} "
             f"ids, {total} counted for {len(valid)} valid lookups")
    print(f"[native+wide] wide cache p={P_WIDE} (E={E_WIDE}), hashtbl_size "
          f"{H_WIDE}, cache_size {C_WIDE} ({mb:.0f} MB of keys, counts, "
          f"slots and rows): 20 counting steps B={B} pooling {POOL} "
          f"(launches B1 1 B2 1 B3 1 each) in {count_s:.2f} s; {len(uniq)} "
          f"distinct ids of {len(valid)} valid lookups "
          f"({int((ids64 >= 2 ** 31).sum())} at 2^31 or above; "
          f"{len(allrows) - len(valid)} pads) each within MAX_PROBES of its "
          "hash, key rows and counts equal the host's np.unique, parts "
          "equal decompose_indices64, pads counted nowhere")
    # determinism: one batch counted into two copies of the state
    batch, _ = wide_batch()
    twins = [clone_cache(wc) for _ in range(2)]
    for tw in twins:
        fbt.update_cache_state(tw, batch[0])
    if not (torch.equal(twins[0].keys, twins[1].keys)
            and torch.equal(twins[0].freq, twins[1].freq)):
        fail("wide counting: two counts of one batch differ")
    print("[native+wide] wide counting of one batch into two copies of the "
          "state: keys and counts bitwise equal")
    del twins
    # populate: the top counts, ties lowest slot first; rows against the
    # plain float32 tt_rows of their parts
    masked = torch.where(wc.keys[:, 0] != -1, wc.freq,
                         torch.full_like(wc.freq, -1)).cpu().numpy()
    t0 = time.perf_counter()
    pop = fbt.cache_populate(wc, wparams.tt_cores, P_WIDE, Q, R)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    order = np.argsort(-masked, kind="stable")[:C_WIDE]
    won = order[masked[order] > 0]
    want_slots = np.full(H_WIDE, -1, np.int32)
    want_slots[won] = np.arange(len(won), dtype=np.int32)
    if not np.array_equal(pop.slots.cpu().numpy(), want_slots):
        fail("wide populate: slots are not the top counts, ties lowest slot "
             "first")
    wslot = torch.as_tensor(won, device="cuda").long()
    parts = [pop.keys[wslot, 2 + t] for t in range(3)]
    with torch.no_grad():
        want_rows = fbt.tt_rows(wparams.tt_cores, P_WIDE, Q, R, None,
                                idx_parts=parts)
    got_rows = pop.weight[:len(won)]
    scale = want_rows.abs().max().item()
    err = (got_rows - want_rows).abs().max().item()
    if not (err <= 1e-6 * scale and not pop.weight[len(won):].any()):
        fail(f"wide populate: rows disagree with tt_rows ({err:.3e})")
    print(f"[native+wide] wide cache_populate: {len(won)} rows cached in "
          f"{pop_s:.2f} s, slots the top counts (ties lowest slot first); "
          f"rows max_abs_err {err:.3e} against the plain float32 tt_rows of "
          f"their parts (limit 1e-6 x {scale:.3e})")
    wparams.cache = pop
    del wc

    # cached steps, SGD and EXACT_ROWWISE_ADAGRAD, against the plain step
    zb, _ = wide_batch()
    hit = (fbt.cache_lookup(pop, zb[0]) >= 0).float().mean().item()
    kw = dict(use_cache=True, probe_cache=True)
    for name in ("SGD", "EXACT_ROWWISE_ADAGRAD"):
        optim = getattr(fbt.OptimType, name)
        c = clone_cache(pop)
        if name != "SGD":
            c.opt_state = torch.zeros(C_WIDE, device="cuda")
        state = (tuple(torch.zeros_like(c_) for c_ in wparams.tt_cores)
                 if name != "SGD" else ())
        prm = fbt.TTEmbeddingParams(
            tuple(c_.clone() for c_ in wparams.tt_cores), state, c)
        label = (f"wide {name} B={B} pooling {POOL} cached step (hit rate "
                 f"{hit:.4f})")
        out, new, ref_out, ref, old = stepped(
            "train_wide_cache",
            fbt.make_fused_train_step(P_WIDE, Q, R, 1, B, optimizer=optim,
                                      device="cuda", **kw),
            fbt.make_fused_train_step(P_WIDE, Q, R, 1, B, optimizer=optim,
                                      device="cuda", **kw, **plain),
            prm, zb, flat3, label)
        line = hold_step(f"[native+wide] {label}: launches B1 1 B2 1 B3 1",
                         out, ref_out, new, ref, old, OUT_TOL, UPDATE_TOL,
                         label)
        print(hold_cache(line, new.cache, ref.cache, old.cache, label))
        del prm, new, ref, old, c
    torch.cuda.empty_cache()

    # serves probing the wide cache: make_serving_fn and the bf16 fold
    sprm = fbt.TTEmbeddingParams(wparams.tt_cores, (), pop)
    (sidx, soffs, _), _ = wide_batch()
    ref = fbt.make_serving_fn(P_WIDE, Q, R, 1, B, impl="xla",
                              device="cuda")(sprm, sidx, soffs)
    scale = ref.abs().max().item()
    hit = (fbt.cache_lookup(pop, sidx) >= 0).float().mean().item()
    fold, fserve = fbt.make_folded_serving_fn(P_WIDE, Q, R, 1, B,
                                              device="cuda")
    fp = fold(sprm)
    pair = fp.setup is not None and fp.setup[1] is not None
    pair_mb = (P_WIDE[0] * P_WIDE[1] + 1) * Q[0] * Q[1] * R[2] * 2 / 1e6
    mode = ("flat mode with the pair table" if pair else
            f"flat mode without the pair table ({pair_mb:.0f} MB in bf16, "
            "past the 96 MiB limit)")
    serves = [("make_serving_fn", fbt.make_serving_fn(
        P_WIDE, Q, R, 1, B, device="cuda"), sprm, want(B1=2)),
        (f"folded bf16, {mode}", fserve, fp, want(B1=1 if pair else 2))]
    for label, fn, arg, expect in serves:
        zero_counts()
        with plain_watch() as plains:
            out = fn(arg, sidx, soffs)
            torch.cuda.synchronize()
        got = counts()
        for k in wrappers:
            paths["serve_wide_cache"][k] += got[k]
        err = (out - ref).abs().max().item()
        print(f"[native+wide] wide serve {label} B={B} pooling {POOL} (hit "
              f"rate {hit:.4f}): launches {launch_text(got)}; max_abs_err "
              f"{err:.3e} vs the plain float32 serve, limit "
              f"{OUT_TOL * scale:.3e} ({OUT_TOL} x max|out| {scale:.3e})")
        if plains or got != expect or not err <= OUT_TOL * scale:
            fail(f"wide serve {label}: launches {got} (expected {expect}), "
                 f"plain versions {plains}, or disagrees with the plain "
                 "serve")
    del fp, fold, fserve

    # the module at this table with use_cache: four calls, populate, one
    # probed call, each held against a plain module loaded with its state
    mkw = dict(tt_p_shapes=P_WIDE, tt_q_shapes=Q, seed=0, learning_rate=LR,
               eps=EPS, use_cache=True, cache_size=C_WIDE,
               hashtbl_size=H_WIDE, device="cuda")
    mod = fbt.TTEmbeddingBag(E_WIDE, D, R[1:-1], **mkw)
    mref = fbt.TTEmbeddingBag(E_WIDE, D, R[1:-1], **mkw, **plain)

    def mbatch():
        n = B * POOL
        return (wide_ids(n), np.arange(0, n + 1, POOL), d_out()[0])

    for i in range(5):
        if i == 4:
            mod.cache_populate()
        module_call(fbt, wrappers, paths["module_wide_cache"], mod, mref,
                    mbatch(), want(B1=2), want(B3=2),
                    f"wide TTEmbeddingBag SGD B={B} pooling {POOL} "
                    + ("probed call" if i == 4 else f"warm-up call {i}"),
                    tag="native+wide")
    hit = mod.cache_hit_rate()
    print(f"[native+wide] wide module: cache_hit_rate() {hit:.4f} on the "
          f"probed call, {int((mod.cache.slots >= 0).sum())} rows cached")
    del mod, mref
    torch.cuda.empty_cache()

    # times, in turns: the reference SGD counting step, native ADAM and
    # LAMB counting steps; the direct-mode and the wide counting steps
    scratch = {
        "reference SGD": (count_step, fbt.TTEmbeddingParams(
            tuple(c.clone() for c in tparams.tt_cores), (),
            fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                                 device="cuda")), nbatches[0])}
    for name in ("ADAM", "LAMB"):
        optim = getattr(fbt.OptimType, name)
        scratch[f"native {name}"] = (native_step(optim, use_cache=True),
                                     native_params(optim), nbatches[0])
    wbatch, _ = wide_batch()
    scratch["wide counting SGD"] = (wcount, wparams, wbatch)
    for group in (("reference SGD", "native ADAM", "native LAMB"),
                  ("reference SGD", "wide counting SGD")):
        got = {k: [] for k in group}
        for name in group + group[::-1]:
            step, prm, batch = scratch[name]

            def call():
                step(prm, *batch, (1e-4, EPS))

            dev, _, mhz = device_ms(call)
            got[name].append((dev, device_ms.ops, host_ms(call), mhz))
        for name, rs in got.items():
            print(f"[time] {name} counting step B={B} pooling {POOL}: "
                  + " / ".join(f"device {d:.4f} ms, host {h:.3f} ms, "
                               f"{o:.1f} device ops" for d, o, h, _ in rs)
                  + f" per step ({mhz_text(rs[-1][3])}) [{card}]")
    print(f"[native+wide] phase took {time.perf_counter() - t_phase:.1f} s; "
          + "; ".join(f"{k} {launch_text(v)}" for k, v in paths.items()))
    return paths


def dlrm_tools_phase(fbt, card, wrappers):
    """Phase 5d of the docstring: the DLRM trainer at full width, the
    checkpoint, the guard, the walkthrough and the benchmark CLI; returns
    the launches of the paths ``train_dlrm``, ``train_dlrm_f32``,
    ``train_dlrm_dg0``, ``dlrm_walkthrough``, ``cli`` and ``cli_generic``."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch import benchmark
    from fbtt_embedding_tpu_torch.examples import train_dlrm
    from fbtt_embedding_tpu_torch.models import dlrm
    from fbtt_embedding_tpu_torch.ops.kernels import tt_flat
    from fbtt_embedding_tpu_torch.ops.kernels.tt_kernel import (
        kernel_core_layouts,
    )
    from fbtt_embedding_tpu_torch.utils import checkpoint, guard, profiling
    from fbtt_embedding_tpu_torch.utils._tree import (
        leaves_with_paths,
        map_leaves,
    )

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def want(**kw):
        return want_launches(wrappers, **kw)

    t_phase = time.perf_counter()
    paths = {k: dict.fromkeys(wrappers, 0) for k in (
        "train_dlrm", "train_dlrm_f32", "train_dlrm_dg0", "dlrm_walkthrough",
        "cli", "cli_generic")}
    cfg = dlrm.DLRMConfig(**DLRM_KW)
    tp, qs, rs = cfg.tt_p_shapes, cfg.tt_q_shapes, cfg.tt_ranks
    nt, d = cfg.num_tables, cfg.embedding_dim
    rng = np.random.default_rng(8)
    batches = [train_dlrm.make_batch(rng, cfg, DLRM_B, "cuda")
               for _ in range(7)]

    def lookup(impl="auto", precision=None):
        return lambda c, i: dlrm.fixed_pool_lookup(c, i, tp, qs, rs,
                                                   precision=precision,
                                                   impl=impl)

    def make_step(lr=DLRM_LR, **kw):
        return dlrm.make_dlrm_train_step(cfg, learning_rate=lr,
                                         device="cuda", **kw)

    def clone(prm):
        return map_leaves(torch.clone, prm)

    plain_kw = dict(impl="xla", precision="highest")
    pstep = make_step(**plain_kw)
    params = dlrm.init_dlrm_params(cfg, seed=0, device="cuda")

    def checked(path, kstep, kw, batch, expect, tols, label):
        """One step of ``kstep`` on ``params`` (launches checked, no plain
        version) held against the plain float32 step on a copy: the loss,
        the pooled embeddings and the logits before the step, and every
        leaf's update (``tols``: loss and embeddings, logits, update; an
        update limit of None holds the update by its cosine)."""
        nonlocal params
        out_tol, logit_tol, update_tol = tols
        old, ref = clone(params), clone(params)
        with torch.no_grad():
            emb = lookup(**kw)(params.tt_cores, batch[1])
            ref_emb = lookup(**plain_kw)(ref.tt_cores, batch[1])
            logits = dlrm.dlrm_forward(params, cfg, *batch[:2], lookup(**kw))
            ref_logits = dlrm.dlrm_forward(ref, cfg, *batch[:2],
                                           lookup(**plain_kw))
        zero_counts()
        with plain_watch() as plains:
            loss, params = kstep(params, *batch)
            torch.cuda.synchronize()
        got = counts()
        for k in wrappers:
            paths[path][k] += got[k]
        if plains or got != expect:
            fail(f"{label}: launches {got} (expected {expect}), plain "
                 f"versions {plains}")
        ref_loss, ref = pstep(ref, *batch)
        lerr = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        escale = ref_emb.abs().max().item()
        eerr = (emb - ref_emb).abs().max().item()
        scale = ref_logits.abs().max().item()
        gerr = (logits - ref_logits).abs().max().item()
        line = (f"[dlrm+tools] {label}: launches {launch_text(got)}, plain "
                f"versions 0; loss {loss.item():.6f} against "
                f"{ref_loss.item():.6f} (relative error {lerr:.3e}, limit "
                f"{out_tol}); pooled embeddings max_abs_err {eerr:.3e} "
                f"(limit {out_tol} x {escale:.3e}); logits max_abs_err "
                f"{gerr:.3e} (limit {logit_tol} x {scale:.3e})")
        if not (lerr <= out_tol and eerr <= out_tol * escale
                and gerr <= logit_tol * scale):
            fail(f"{label}: loss, embeddings or logits disagree with the "
                 f"plain step: {line}")
        # each leaf's update against the plain step's: within update_tol of
        # its largest element (float32 staging), or by their cosine (bf16)
        rel = {"cores": [0.0, 1.0], "mlp": [0.0, 1.0]}
        for (name, new), (_, r_new), (_, r_old) in zip(
                leaves_with_paths(params), leaves_with_paths(ref),
                leaves_with_paths(old)):
            dp, dp_ref = (new - r_old).flatten(), (r_new - r_old).flatten()
            upd = dp_ref.abs().max().item()
            err = (dp - dp_ref).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(dp, dp_ref,
                                                        dim=0).item()
            ok = (cos >= COS_MIN if update_tol is None
                  else err <= update_tol * upd)
            if not (torch.isfinite(new).all() and upd > 0 and ok):
                fail(f"{label}: {name}'s update disagrees with the plain "
                     f"step's (max error {err:.3e} against {upd:.3e}, "
                     f"cosine {cos:.6f})")
            part = rel["cores" if name.startswith(".tt_cores") else "mlp"]
            part[0], part[1] = max(part[0], err / upd), min(part[1], cos)
        limit = (f"cosine limit {COS_MIN}" if update_tol is None
                 else f"limit {update_tol}")
        print(line + "; " + ", ".join(
            f"over the {what} max|dp - dp_plain| / max|dp_plain| "
            f"{rel[k][0]:.3e}, least cos(dp, dp_plain) {rel[k][1]:.6f}"
            for k, what in (("cores", f"{len(params.tt_cores)} cores"),
                            ("mlp", "MLP weights and biases")))
            + f" ({limit})")

    # 1. five bf16 steps (pair mode: B1 once forward, B3 twice backward),
    # one with float32 staging (B1 twice, no pair table), one under
    # FBTT_DG0=fused (B6 for B3's i1 pass)
    kstep = make_step()
    for i in range(5):
        checked("train_dlrm", kstep, {}, batches[i], want(B1=1, B3=2),
                (OUT_TOL, DLRM_LOGIT_TOL, None),
                f"dlrm SGD step {i} bf16 B={DLRM_B}")
    checked("train_dlrm_f32", make_step(precision="highest"),
            dict(precision="highest"), batches[5], want(B1=2, B3=2),
            (F32_OUT_TOL, F32_OUT_TOL, F32_UPDATE_TOL),
            f"dlrm SGD step float32 staging B={DLRM_B}")
    with knob({"FBTT_DG0": "fused"}):
        checked("train_dlrm_dg0", kstep, {}, batches[6],
                want(B1=1, B3=1, B6=1), (OUT_TOL, DLRM_LOGIT_TOL, None),
                f"dlrm SGD step FBTT_DG0=fused bf16 B={DLRM_B}")
    # the step asks nothing of the host: no synchronising call in a step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            kstep(clone(params), *batches[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"[dlrm+tools] dlrm step under torch.cuda.set_sync_debug_mode"
          f"('warn'): {len(syncs)} synchronising call(s)"
          + (f": {syncs[:3]}" if syncs else ""))

    # 2. checkpoint: save, restore into fresh params (seed 99), the forward
    # bitwise equal; the same through npz
    probe = train_dlrm.make_batch(np.random.default_rng(7), cfg, DLRM_B,
                                 "cuda")
    with torch.no_grad():
        before = dlrm.dlrm_forward(params, cfg, *probe[:2])
    fresh = dlrm.init_dlrm_params(cfg, seed=99, device="cuda")  # a restart
    tmp = tempfile.mkdtemp(prefix="dlrm_ckpt_")
    try:
        for fmt, save, restore, name in (
                ("torch.save", checkpoint.save, checkpoint.restore, "ck"),
                ("npz", checkpoint.save_npz, checkpoint.restore_npz,
                 "ck.npz")):
            path = os.path.join(tmp, name)
            t0 = time.perf_counter()
            save(path, params)
            got = restore(path, like=fresh)
            with torch.no_grad():
                after = dlrm.dlrm_forward(got, cfg, *probe[:2])
            if not torch.equal(before, after):
                fail(f"checkpoint ({fmt}): the restored forward differs")
            print(f"[dlrm+tools] checkpoint {fmt}: {os.path.getsize(path)} "
                  f"bytes, save + restore {time.perf_counter() - t0:.2f} s; "
                  "the restored params' forward bitwise equal")
    finally:
        shutil.rmtree(tmp)

    # 3. guard: four guarded steps (sampled every 2) pass; a NaN placed in
    # one core is named
    gstep = guard.guard_step(kstep, every=2)
    gparams = clone(params)
    zero_counts()
    for i in range(4):
        _, gparams = gstep(gparams, *batches[i])
    torch.cuda.synchronize()
    got = counts()
    for k in wrappers:
        paths["train_dlrm"][k] += got[k]
    if got != want(B1=4, B3=8):
        fail(f"guarded steps: launches {got}")
    gparams.tt_cores[1][3, 17, 5] = float("nan")
    if bool(guard.finite_flag(gparams)):
        fail("guard: finite_flag missed a NaN")
    try:
        guard.assert_finite(gparams)
        fail("guard: assert_finite missed a NaN")
    except guard.NonFiniteError as e:
        if e.leaf_path != "params.tt_cores[1]":
            fail(f"guard named {e.leaf_path!r}, not 'params.tt_cores[1]'")
        named = str(e)
    print(f"[dlrm+tools] guard_step(every=2): four steps passed; a NaN in "
          f"core 1: {named}")
    del gparams

    # 4. the walkthrough at full size: 40 steps, the checkpoint's bitwise
    # probe, held-out AUC (B1 43 = 40 steps + 2 probes + the eval forward)
    zero_counts()
    t0 = time.perf_counter()
    with plain_watch() as plains:
        res = train_dlrm.main(["--steps", "40"])
    torch.cuda.synchronize()
    got = counts()
    paths["dlrm_walkthrough"] = got
    if plains or got != want(B1=43, B3=80):
        fail(f"walkthrough: launches {got}, plain versions {plains}")
    if not res["last_loss"] < res["first_loss"]:
        fail(f"walkthrough: loss did not fall ({res['first_loss']} -> "
             f"{res['last_loss']})")
    print(f"[dlrm+tools] train_dlrm.main(['--steps', '40']): loss "
          f"{res['first_loss']:.4f} -> {res['last_loss']:.4f}, held-out AUC "
          f"{res['auc']:.4f}; launches {launch_text(got)}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")

    # 5. the benchmark CLI at the reference headline (its defaults), with the
    # nn.EmbeddingBag baseline, then on the generic kernels
    sol = profiling.speed_of_light(P, Q, R[1:-1], nnz=B * POOL, batch_size=B)
    steps = 3 + 10 + 100  # the slope's warm-up, k1 and k2
    for path, argv, expect in (
            ("cli", ["--iters", "100", "--run-baseline"],
             want(B1=steps, B2=steps, B3=steps)),
            ("cli_generic", ["--iters", "100", "--impl", "pallas"],
             want(B4=steps, B5=steps))):
        zero_counts()
        with plain_watch() as plains:
            res = benchmark.main(argv)
        torch.cuda.synchronize()
        got = counts()
        paths[path] = got
        if plains or got != expect:
            fail(f"benchmark {argv}: launches {got}, plain versions {plains}")
        base = (f", nn.EmbeddingBag(sparse) + SGD "
                f"{res['baseline_us_per_nnz']:.4f} us/nnz"
                if "baseline_us_per_nnz" in res else "")
        print(f"[time] python -m fbtt_embedding_tpu_torch.benchmark "
              f"{' '.join(argv)}: TTEmbeddingBag FWD-BWD "
              f"{res['tt_us_per_nnz']:.4f} us/nnz{base}; launches "
              f"{launch_text(got)}; speed_of_light t_sol_s "
              f"{sol['t_sol_s']:.3e} s ({sol['t_sol_s'] / (B * POOL) * 1e6:.5f}"
              f" us/nnz, {sol['bound']}-bound, {sol['device']}) [{card}]")
        torch.cuda.empty_cache()

    # 6. times: the step's device ms, device operations and host ms, with
    # the lookup's forward + backward (with and without pair mode, in
    # turns), the pair-table build and the dense tower split out
    tparams = clone(params)
    tstep = make_step(lr=1e-5)
    batch = batches[0]

    def call():
        tstep(tparams, *batch)

    dev, per, mhz = device_ms(call, n=25)
    ops = device_ms.ops
    host = host_ms(call)
    cores = [c.detach().requires_grad_() for c in tparams.tt_cores]
    g_emb = torch.randn(nt, DLRM_B, d, device="cuda")

    def lookup_call():
        emb = dlrm.fixed_pool_lookup(cores, batch[1], tp, qs, rs)
        torch.autograd.grad(emb, cores, g_emb)

    looks = {"pair": [], "no pair": []}
    for mode in ("pair", "no pair", "no pair", "pair"):
        # FBTT_PAIR unset: pair mode by nza (32768 here); "0": never
        with knob({"FBTT_PAIR": None if mode == "pair" else "0"}):
            looks[mode].append((device_ms(lookup_call, n=25)[0],
                                device_ms.ops))
    gk = kernel_core_layouts([c.detach() for c in cores], tp, qs, rs)
    pair_ms = device_ms(lambda: tt_flat._pair_table(
        gk, tp, qs, rs, nt, torch.bfloat16))[0]
    # the two one-hot products of the lookup: the pool (T*B bags by nnz)
    # and dG0 (nnz by T*p0), on this batch's plan
    nnz = batch[1].numel()
    pos = torch.arange(nnz, dtype=torch.int32, device="cuda")
    plan, nza = tt_flat._lookup_plan(
        batch[1].reshape(nnz), (pos // cfg.pooling_factor) % DLRM_B,
        pos // (DLRM_B * cfg.pooling_factor), None, None, tp, qs, rs, nt,
        DLRM_B, torch.bfloat16, False, False)
    rows = torch.randn(nza, d, device="cuda").to(torch.bfloat16)
    dz0 = torch.randn(nza, qs[0] * rs[1], device="cuda")
    pool_ms = device_ms(lambda: tt_flat._pool_flat(
        rows, plan, nt * DLRM_B, torch.bfloat16))[0]
    dg0_ms = device_ms(lambda: tt_flat._dg0(plan, dz0, nt * tp[0], qs[0],
                                            rs[1]))[0]
    mlp = map_leaves(lambda t: t.detach().requires_grad_(),
                     (tparams.bottom_mlp, tparams.top_mlp))
    mlp_leaves = [t for _, t in leaves_with_paths(mlp)]
    emb = torch.randn(nt, DLRM_B, d, device="cuda", requires_grad=True)

    def dense_call():
        z = dlrm._interact(dlrm._mlp_apply(mlp[0], batch[0]), emb)
        loss = dlrm.bce_loss(dlrm._mlp_apply(mlp[1], z)[:, 0], batch[2])
        torch.autograd.grad(loss, mlp_leaves + [emb])

    dense_ms = device_ms(dense_call, n=25)[0]
    look = looks["pair"][0][0]
    print(f"[time] dlrm step SGD B={DLRM_B} pooling {cfg.pooling_factor} "
          f"T={nt} (bf16 staging, pair mode): device {dev:.4f} ms, {ops:.1f} "
          f"device ops, host {host:.3f} ms per step (busy share "
          f"{dev / host:.3f}); of the device time: the lookup forward + "
          f"backward {look:.4f} ms (its pair-table build {pair_ms:.4f}, "
          f"one-hot pool {pool_ms:.4f}, one-hot dG0 {dg0_ms:.4f}), the "
          f"MLPs and the interaction forward + backward with the loss "
          f"{dense_ms:.4f}, the rest (update, glue) "
          f"{dev - look - dense_ms:.4f} ({mhz_text(mhz)}) [{card}]")
    print(f"[time] dlrm lookup forward + backward, in turns pair, no pair, "
          f"no pair, pair: pair mode "
          + " / ".join(f"{m:.4f} ms ({o:.1f} ops)" for m, o in looks["pair"])
          + ", without pair mode "
          + " / ".join(f"{m:.4f} ms ({o:.1f} ops)"
                       for m, o in looks["no pair"]) + f" [{card}]")
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    print("[time] dlrm step's largest device kernels (ms per step): "
          + "; ".join(f"{kernel_name(k)} {v:.4f}" for k, v in top))
    del tparams, cores, mlp, emb, plan, rows, dz0
    torch.cuda.empty_cache()
    print(f"[dlrm+tools] phase took {time.perf_counter() - t_phase:.1f} s; "
          + "; ".join(f"{k} {launch_text(v)}" for k, v in paths.items()))
    return paths


# the knob phase's checks: (B, knobs, (B1, B2, B3) of one counting step).
# FBTT_PAIR "1" skips B1's i1 pass; FBTT_FUSED_APPLY "0" trades B2 for
# B1's and B3's i2 passes (autograd through FlatLookup), and "1" takes B2
# at B=2048 (nnz 40960, pair mode by nza)
KNOB_RUNS = (
    (B, {}, (1, 1, 1)),
    (B, {"FBTT_PAIR": "1"}, (0, 1, 1)),
    (B, {"FBTT_PAIR": "0"}, (1, 1, 1)),
    (B, {"FBTT_FUSED_APPLY": "0"}, (2, 0, 2)),
    (B, {"FBTT_FUSED_APPLY": "1"}, (1, 1, 1)),
    (4 * B, {}, (1, 0, 2)),
    (4 * B, {"FBTT_FUSED_APPLY": "1"}, (0, 1, 1)),
    (4 * B, {"FBTT_FUSED_APPLY": "0"}, (1, 0, 2)),
    (4 * B, {"FBTT_PAIR": "0"}, (2, 0, 2)),
    (4 * B, {"FBTT_PAIR": "1"}, (1, 0, 2)),
)
# the gates' sweeps: batch sizes of the headline counting step at pooling
# 20 (FBTT_PAIR: nnz 4160, 20480, 65440; FBTT_FUSED_APPLY: nnz 8160,
# 30720, 65440) and of the DLRM's lookup (T=8, pooling 8, the
# walkthrough's tables: nnz 8192, 32768, 65536); every B a multiple of 8
# (flat_available). Three points a sweep keep the phase near a minute:
# each turn is one profiler session.
KNOB_PAIR_BS = (208, 1024, 3272)
KNOB_APPLY_BS = (408, 1536, 3272)
KNOB_DLRM_BS = (128, 512, 1024)
KNOB_DLRM = dict(tables=8, pool=8, p=[100, 100, 100], e=10 ** 6)


def knob_phase(fbt, card, wrappers, cores, train_batch, plain_steps):
    """``FBTT_PAIR`` and ``FBTT_FUSED_APPLY`` on the card: the headline
    counting step under each of KNOB_RUNS, twice from the same state
    (bitwise equal) and against the plain float32 step, with its launches;
    then each gate on against off, in turns, over its sweep (device ms,
    device operations, host ms). Returns the checks' launches."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.models import dlrm

    t_phase = time.perf_counter()

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def fresh(cache):
        return fbt.TTEmbeddingParams(
            fbt.params_from_jax(cores, device="cuda").tt_cores, (), cache)

    base = fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                                device="cuda")
    steps = {b: fbt.make_fused_train_step(P, Q, R, 1, b, use_cache=True,
                                          device="cuda") for b in (B, 4 * B)}
    batches = {b: train_batch(b, False) for b in (B, 4 * B)}
    launches = dict.fromkeys(wrappers, 0)
    for b, env, want in KNOB_RUNS:
        want = {**dict.fromkeys(wrappers, 0), **dict(zip(
            ("seg_transform", "seg_fused_i2", "seg_accum"), want))}
        label = (f"counting step B={b} pooling {POOL} "
                 + (" ".join(f"{k}={v}" for k, v in env.items())
                    or "no knob set"))
        runs = []
        with knob(env):
            for _ in range(2):
                prm = fresh(clone_cache(base))
                zero_counts()
                out, new = steps[b](prm, *batches[b], (LR, EPS))
                torch.cuda.synchronize()
                runs.append((out, new, counts()))
        (out, new, got), (out2, new2, got2) = runs
        if got != want or got2 != want:
            fail(f"{label}: launches {got} / {got2}, expected {want}")
        if not (torch.equal(out, out2) and all(
                torch.equal(a, c) for a, c in zip(new.tt_cores,
                                                  new2.tt_cores))
                and torch.equal(new.cache.freq, new2.cache.freq)):
            fail(f"{label}: two runs from the same state differ")
        old = fresh(None)
        ref_out, ref = plain_steps[b](
            fbt.TTEmbeddingParams(tuple(c.clone() for c in old.tt_cores),
                                  (), None), *batches[b], (LR, EPS))
        for k in wrappers:
            launches[k] += got[k]
        line = (f"[knobs] {label}: launches B1 {got['seg_transform']} B2 "
                f"{got['seg_fused_i2']} B3 {got['seg_accum']}, twice "
                "bitwise equal")
        print(hold_step(line, out, ref_out, new, ref, old, OUT_TOL,
                        UPDATE_TOL, label), flush=True)
        del runs, out, new, out2, new2
    del base
    torch.cuda.empty_cache()

    def turns(name, on, off, call):
        """(on, off): [(device ms, device ops, host ms)] x 2 each, in turns
        on, off, off, on."""
        res = {on: [], off: []}
        for v in (on, off, off, on):
            with knob({name: v}):
                dev = device_ms(call, n=10)[0]
                res[v].append((dev, device_ms.ops, host_ms(call, reps=10)))
        return res[on], res[off]

    def text(rows):
        return " / ".join(f"{d:.4f} ms ({o:.0f} ops, host {h:.3f})"
                          for d, o, h in rows)

    def sweep(what, name, on, off, bs, nnz_of, make_call):
        """Each B's A/B line; [(nnz, whether ``on``'s device time, the mean
        of its two turns, is the lower)]."""
        wins = []
        for b in bs:
            a, z = turns(name, on, off, make_call(b))
            da, dz = (statistics.mean(r[0] for r in x) for x in (a, z))
            wins.append((nnz_of(b), da < dz))
            print(f"[time] knobs: {what} B={b} (nnz {nnz_of(b)}), in turns "
                  f"{name}={on}, {off}, {off}, {on}: {on} {text(a)}; {off} "
                  f"{text(z)}; {on} - {off} {da - dz:+.4f} ms of device "
                  f"time [{card}]", flush=True)
            torch.cuda.empty_cache()
        return wins

    scratch = fresh(fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                                         device="cuda"))

    def headline(b):
        step = fbt.make_fused_train_step(P, Q, R, 1, b, use_cache=True,
                                         device="cuda")
        batch = train_batch(b, False)
        return lambda: step(scratch, *batch, (1e-5, EPS))

    pair_wins = sweep("FBTT_PAIR, headline counting step", "FBTT_PAIR",
                      "1", "0", KNOB_PAIR_BS, lambda b: b * POOL, headline)
    apply_wins = sweep("FBTT_FUSED_APPLY, headline counting step",
                       "FBTT_FUSED_APPLY", "1", "0", KNOB_APPLY_BS,
                       lambda b: b * POOL, headline)
    del scratch
    torch.cuda.empty_cache()

    nt, pool, dp = KNOB_DLRM["tables"], KNOB_DLRM["pool"], KNOB_DLRM["p"]
    de = KNOB_DLRM["e"]
    dcores = [c.requires_grad_() for c in fbt.params_from_jax(
        fbt.init_tt_cores(np.random.default_rng(0), "uniform", nt, de, D,
                          dp, Q, R), device="cuda").tt_cores]
    rng = np.random.default_rng(3)

    def dlrm_lookup(b):
        idx = torch.as_tensor(rng.integers(0, de, size=(nt, b, pool)),
                              dtype=torch.int32, device="cuda")
        g = torch.randn(nt, b, D, device="cuda")

        def call():
            emb = dlrm.fixed_pool_lookup(dcores, idx, dp, Q, R)
            torch.autograd.grad(emb, dcores, g)
        return call

    dlrm_wins = sweep(f"FBTT_PAIR, DLRM lookup forward + backward T={nt} "
                      f"pooling {pool}", "FBTT_PAIR", "1", "0",
                      KNOB_DLRM_BS, lambda b: nt * b * pool, dlrm_lookup)
    del dcores
    torch.cuda.empty_cache()

    def crossing(wins):
        return ", ".join(f"nnz {n} {'yes' if w else 'no'}" for n, w in wins)

    print(f"[knobs] does it pay on this card (device time, mean of two "
          f"turns)? pair mode at the headline: {crossing(pair_wins)}; at "
          f"the DLRM's lookup: {crossing(dlrm_wins)}; the fused apply: "
          f"{crossing(apply_wins)} [{card}]")
    print(f"[knobs] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launch_text(launches)}", flush=True)
    return launches


def pool_phase(fbt, card, params):
    """Phase 4c of the docstring: pools above 4096 rows (the deterministic
    segment sum): the folded serve at T=1, B=8192 and the DLRM's lookup
    (forward and backward) at T=8, B=1024, each run twice and required
    bitwise equal, held against the plain float32 path; then the pool's
    device time there against the parent's ``index_add_`` pool on the same
    rows, in turns."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.ops.hot_scatter import segment_sum
    from fbtt_embedding_tpu_torch.parallel import fixed_pool_lookup

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    bb = 8192
    idx = torch.as_tensor(rng.integers(0, E, size=bb * POOL), device="cuda")
    offs = torch.arange(0, bb * POOL + 1, POOL, device="cuda")
    fold, serve = fbt.make_folded_serving_fn(P, Q, R, 1, bb, device="cuda")
    fp = fold(params)
    with plain_watch() as plains:
        out_a = serve(fp, idx, offs)
        out_b = serve(fp, idx, offs)
        torch.cuda.synchronize()
    ref = fbt.make_serving_fn(P, Q, R, 1, bb, impl="xla", device="cuda")(
        params, idx, offs)
    scale = ref.abs().max().item()
    err = (out_a - ref).abs().max().item()
    same = torch.equal(out_a, out_b)
    print(f"[pool] folded serve T=1 B={bb} pooling {POOL} ({bb} pooled rows): "
          f"two runs bitwise equal {same}; max_abs_err {err:.3e} vs plain "
          f"f32 (limit {OUT_TOL} x {scale:.3e}); plain versions "
          f"{plains or 0}", flush=True)
    if plains or not same or not err <= OUT_TOL * scale:
        fail("the folded serve above 4096 pooled rows")
    del fp, out_a, out_b, ref

    dk = DLRM_KW
    pd, t8, bd, ld = dk["tt_p_shapes"], dk["num_tables"], 1024, \
        dk["pooling_factor"]
    dcores = [torch.tensor(c, device="cuda") for c in fbt.init_tt_cores(
        np.random.default_rng(0), "uniform", t8, dk["num_embeddings"], D,
        pd, Q, R)]
    didx = torch.as_tensor(rng.integers(0, dk["num_embeddings"], size=(
        t8, bd, ld)).astype(np.int32), device="cuda")
    dout = torch.as_tensor(rng.normal(size=(t8, bd, D)).astype(np.float32),
                           device="cuda")

    def lookup(impl):
        leaves = [c.detach().requires_grad_() for c in dcores]
        out = fixed_pool_lookup(leaves, didx, pd, Q, R, impl=impl)
        return out.detach(), torch.autograd.grad(out, leaves, dout)

    with plain_watch() as plains:
        (oa, ga), (ob, gb) = lookup("auto"), lookup("auto")
        torch.cuda.synchronize()
    same = torch.equal(oa, ob) and all(torch.equal(a, b)
                                       for a, b in zip(ga, gb))
    oref, gref = lookup("xla")
    scale = oref.abs().max().item()
    err = (oa - oref).abs().max().item()
    cos = min(torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), dim=0).item() for a, b in zip(ga, gref))
    print(f"[pool] DLRM lookup T={t8} B={bd} pooling {ld} ({t8 * bd} pooled "
          f"rows), forward and backward: two runs bitwise equal {same}; "
          f"output max_abs_err {err:.3e} vs plain f32 (limit {OUT_TOL} x "
          f"{scale:.3e}); least cos(grad, grad_plain) {cos:.6f} (limit "
          f"{COS_MIN}); plain versions {plains or 0}", flush=True)
    if plains or not same or not err <= OUT_TOL * scale or cos < COS_MIN:
        fail("the DLRM lookup above 4096 pooled rows")
    del dcores, oa, ob, ga, gb, oref, gref

    for label, n, tb in ((f"serve T=1 B={bb}", bb * POOL, bb),
                         (f"DLRM T={t8} B={bd}", t8 * bd * ld, t8 * bd)):
        rows = torch.randn(n, D, device="cuda")
        seg = torch.randint(0, tb, (n,), dtype=torch.int32, device="cuda")

        def new():
            return segment_sum(rows, seg, tb)

        def old():  # the parent's pool: float atomics
            out = torch.zeros((tb + 1, D), device="cuda")
            out.index_add_(0, seg.long(), rows)
            return out[:tb]

        got = new()
        err = (got - old()).abs().max().item()
        same = torch.equal(got, new())
        first = old()
        old_same = all(torch.equal(first, old()) for _ in range(4))
        us = {"segment_sum": [], "index_add_": []}
        for name, fn in (("segment_sum", new), ("index_add_", old),
                         ("index_add_", old), ("segment_sum", new)):
            us[name].append(device_ms(fn)[0] * 1e3)
        print(f"[time] pool above 4096 rows, {label} ({n} rows of {D} into "
              f"{tb}), device us per call in turns: segment_sum "
              f"{us['segment_sum'][0]:.2f} / {us['segment_sum'][1]:.2f} "
              f"({device_ms.ops:g} device operations), the parent's "
              f"index_add_ {us['index_add_'][0]:.2f} / "
              f"{us['index_add_'][1]:.2f}; max_abs_err {err:.3e} between "
              f"them; segment_sum twice bitwise equal {same}, index_add_ "
              f"five times {old_same} [{card}]", flush=True)
        if not same or not err <= 1e-4 * got.abs().max().item():
            fail(f"segment_sum at {label}")
    print(f"[pool] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def world_device_ms(fn, n=10, pad=WORLD_PAD_CALLS):
    """Device ms per call of ``fn`` (run by every rank of a world the same
    number of times; it may hold collectives): the summed durations of the
    device work between two marker kernels around ``n`` calls under
    ``torch.profiler``, and the device operations per call. As in
    :func:`device_ms`, untimed calls run inside the session on each side
    of the markers (a fixed count of them, ``pad``, so that every rank
    calls ``fn`` as often as the others): the tracer misses work at
    a session's ends (on the world of 2, after the walkthrough ran in the
    rank's process, every marker of a serve's session was lost without
    them). The ranks start each session together (a barrier) and agree on
    its outcome (an all-reduce of a flag), so that a session where any
    rank's tracer dropped a marker is run again by every rank, up to
    PROFILER_TRIES sessions; (None, None) after that."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)
            for _ in range(n):
                fn()
            torch.cuda._sleep(1)
            for _ in range(pad):
                fn()
            torch.cuda.synchronize()
        cuda = [ev for ev in prof.events()
                if ev.device_type == DeviceType.CUDA]
        spins = sorted((ev.time_range for ev in cuda
                        if "spin_kernel" in ev.name), key=lambda r: r.start)
        flag = torch.tensor([int(len(spins) == 2)], device="cuda")
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if flag.item():
            lo, hi = spins[0].end, spins[1].start
            inside = [ev for ev in cuda
                      if lo <= ev.time_range.start and ev.time_range.end <= hi]
            return (sum(ev.time_range.elapsed_us() for ev in inside) / n
                    / 1e3, len(inside) / n)
    return None, None


def world_host_ms(fn, n=10):
    """Median host ms of one call of ``fn`` ending in a synchronise, over
    ``n`` calls after a barrier (every rank runs the same calls)."""
    import torch
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def world_times(fn, n=MULTI_STEPS, pad=WORLD_PAD_CALLS):
    """``(device ms, device operations, host ms, collective ms, collective
    calls)`` per call of a world's step ``fn``; the collectives' host time
    is read in a run of its own (each collective then synchronises)."""
    from fbtt_embedding_tpu_torch.parallel import collectives

    dev, ops = world_device_ms(fn, n, pad)
    host = world_host_ms(fn, n)
    with collectives.timed() as rec:
        for _ in range(n):
            fn()
    return dev, ops, host, rec["ms"] / n, rec["calls"] / n


def times_of(t):
    dev, ops, host, coll, calls = t
    dev_txt = "not measured" if dev is None else f"{dev:.3f} ms"
    return (f"device {dev_txt} ({ops} device operations), host {host:.3f} "
            f"ms, collectives {coll:.3f} ms host time ({calls:g} calls) "
            "per step")


def multi_child(spec):
    """One rank of phase 5e's worlds (``chip_smoke.py --multi-child
    world,rank,backend,init_url,out_dir``): the data-parallel step at the
    headline, the CSR path from the native loader, and (world 2) the
    table-sharded DLRM, each held against the single-device step in this
    process, and the walkthrough on the mesh; writes ``rank<r>.json``
    (launches per path, times)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    world, rank, backend, init, out_dir = spec.split(",", 4)
    world, rank = int(world), int(rank)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch import native
    from fbtt_embedding_tpu_torch.examples import train_dlrm
    from fbtt_embedding_tpu_torch.models import dlrm
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import seg_accum
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        seg_accum_dg0,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import (
        seg_fused_i2,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
        seg_transform,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.tt_bwd import tt_bwd
    from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import tt_fwd
    from fbtt_embedding_tpu_torch.parallel import host_local_slice
    from fbtt_embedding_tpu_torch.parallel.collectives import all_gather_cat
    from fbtt_embedding_tpu_torch.utils import guard
    from fbtt_embedding_tpu_torch.utils._tree import (
        leaves_with_paths,
        map_leaves,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"seg_transform": seg_transform, "seg_fused_i2": seg_fused_i2,
                "seg_accum": seg_accum, "seg_accum_dg0": seg_accum_dg0,
                "tt_fwd": tt_fwd, "tt_bwd": tt_bwd}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    fbt.initialize_distributed(init, world, rank, backend=backend,
                               device="cuda", timeout_s=300)
    tag = f"[multi] world {world} {backend} rank {rank}"
    res = {"launches": {}, "times": {}}
    try:
        cuda = torch.device("cuda", torch.cuda.current_device())
        mesh = fbt.make_mesh((world,), ("dp",), device_type="cuda")
        bl = MULTI_B // world
        spec_b = (None, "dp")

        # 1. the data-parallel step at the headline, LFU counting on
        rng = np.random.default_rng(0)
        cores_np = fbt.init_tt_cores(rng, "uniform", 1, E, D, P, Q, R)
        g_idx = rng.integers(0, E, size=(1, MULTI_B, POOL)).astype(np.int32)
        g_dout = rng.normal(size=(1, MULTI_B, D)).astype(np.float32)

        def fresh():
            prm = fbt.params_from_jax(cores_np, device=cuda)
            prm.cache = fbt.make_cache_state(E, E // 10, D,
                                             num_embeddings=E, device=cuda)
            return prm

        step = fbt.make_sharded_fused_train_step(
            mesh, P, Q, R, 1, MULTI_B, POOL, use_cache=True, device=cuda)
        idx_l = torch.tensor(host_local_slice(mesh, spec_b, g_idx),
                             device=cuda)
        dout_l = torch.tensor(host_local_slice(mesh, spec_b, g_dout),
                              device=cuda)
        lr_eps = (LR, EPS)
        zero_counts()
        with plain_watch() as plains:
            out_a, prm_a = step(fresh(), idx_l, dout_l, lr_eps)
            torch.cuda.synchronize()
        got = counts()
        res["launches"]["train_multi_dp"] = got
        out_b, prm_b = step(fresh(), idx_l, dout_l, lr_eps)
        same = (torch.equal(out_a, out_b)
                and all(torch.equal(a, b) for a, b in zip(prm_a.tt_cores,
                                                          prm_b.tt_cores))
                and torch.equal(prm_a.cache.freq, prm_b.cache.freq))
        # the same kernels as one device on this rank's block
        one = fbt.make_fused_train_step(P, Q, R, 1, bl, use_cache=True,
                                        device=cuda)
        zero_counts()
        one(fresh(), idx_l.reshape(-1), torch.arange(
            0, bl * POOL + 1, POOL, device=cuda), dout_l, lr_eps)
        want = counts()
        for c in prm_a.tt_cores:
            guard.assert_replicas_agree(mesh, "dp", c, what="core")
        guard.assert_replicas_agree(mesh, "dp", prm_a.cache.freq.sum(),
                                    what="LFU count total")
        out_all = all_gather_cat(out_a[0], mesh.get_group("dp"))[None]
        ref_step = fbt.make_fused_train_step(P, Q, R, 1, MULTI_B,
                                             use_cache=True, device=cuda)
        ref_out, ref = ref_step(fresh(), g_idx.reshape(-1), np.arange(
            0, MULTI_B * POOL + 1, POOL), g_dout, lr_eps)
        line = (f"{tag}: dp SGD step with LFU counting, global B={MULTI_B} "
                f"({bl} a rank) pooling {POOL}: launches {launch_text(got)} "
                f"(one device on the rank's block: {launch_text(want)}), "
                f"plain versions {plains or 0}; two runs bitwise equal "
                f"{same}")
        line = hold_step(line, out_all, ref_out, prm_a, ref, fresh(),
                         OUT_TOL, UPDATE_TOL, f"{tag} dp step")
        counts_equal = torch.equal(prm_a.cache.freq, ref.cache.freq)
        print(line + f"; LFU counts equal to one device's over the global "
              f"batch {counts_equal}", flush=True)
        if plains or got != want or got["seg_accum"] == 0 or not same \
                or not counts_equal:
            fail(f"{tag}: the dp step's launches, repeatability or counts")
        del prm_b, out_b, ref
        scratch = fresh()
        res["times"]["dp"] = world_times(
            lambda: step(scratch, idx_l, dout_l, (1e-4, EPS)))
        print(f"{tag}: dp step {times_of(res['times']['dp'])} [{card_line()}]",
              flush=True)

        # 2. the CSR path: native loader batches (Zipf 1.05) through
        # csr_step_adapter into the dp step
        n_csr = MULTI_STEPS
        rate_loader = native.PrefetchLoader(E, 1, MULTI_B, POOL, alpha=1.05,
                                            seed=100, num_batches=4 * n_csr)
        t0 = time.perf_counter()
        n_pulled = sum(1 for _ in rate_loader)
        loader_rate = n_pulled / (time.perf_counter() - t0)
        rate_loader.close()
        adapter = fbt.csr_step_adapter(step, 1, bl, POOL)

        def block(idx, offs):
            lo, hi = int(offs[rank * bl]), int(offs[(rank + 1) * bl])
            return idx[lo:hi], offs[rank * bl:(rank + 1) * bl + 1] - lo

        first = native.generate_batch(100, E, 1, MULTI_B, POOL, alpha=1.05)
        c_idx, c_offs = block(first[0], first[1])
        out_c, _ = adapter(fresh(), c_idx, c_offs, dout_l, lr_eps)
        out_f, _ = step(fresh(), torch.tensor(c_idx.reshape(1, bl, POOL),
                                              device=cuda), dout_l, lr_eps)
        if not torch.equal(out_c, out_f):
            fail(f"{tag}: the CSR adapter disagrees with the fixed batch")
        loader = native.PrefetchLoader(E, 1, MULTI_B, POOL, alpha=1.05,
                                       seed=100, num_batches=n_csr)
        zero_counts()
        dist.barrier()
        t0 = time.perf_counter()
        with plain_watch() as plains:
            for g_i, g_o, _ in loader:
                adapter(scratch, *block(g_i, g_o), dout_l, (1e-4, EPS))
            torch.cuda.synchronize()
        csr_ms = (time.perf_counter() - t0) * 1e3 / n_csr
        loader.close()
        got = counts()
        res["launches"]["train_multi_csr"] = got
        res["times"]["csr_ms"], res["times"]["loader_bps"] = csr_ms, loader_rate
        print(f"{tag}: CSR path ({n_csr} PrefetchLoader batches, Zipf 1.05, "
              f"E={E}, global B={MULTI_B} pooling {POOL}, through "
              f"csr_step_adapter): launches {launch_text(got)}, plain "
              f"versions {plains or 0}; adapter output bitwise the fixed "
              f"batch's; {csr_ms:.3f} ms a step with the loader "
              f"({1e3 / csr_ms:.1f} steps/s); the loader alone "
              f"{loader_rate:.1f} batches/s [{card_line()}]", flush=True)
        # B2 and B3 once a step on the flat path, with or without pair mode
        if plains or got["seg_fused_i2"] != n_csr \
                or got["seg_accum"] != n_csr:
            fail(f"{tag}: the CSR path's launches")
        del scratch

        # 3. the table-sharded DLRM at DLRM_KW on a (1, world) mesh
        if world > 1:
            dmesh = fbt.make_mesh((1, world), ("dp", "mp"),
                                  device_type="cuda")
            cfg = dlrm.DLRMConfig(**DLRM_KW)
            full = dlrm.init_dlrm_params(cfg, seed=0, device=cuda)
            batch = train_dlrm.make_batch(np.random.default_rng(8), cfg,
                                          DLRM_B, cuda)
            rows = (("dp", "mp"),)
            local = (host_local_slice(dmesh, rows, batch[0]),
                     host_local_slice(dmesh, ("mp", "dp"), batch[1]),
                     host_local_slice(dmesh, rows, batch[2]))
            lookup = fbt.make_table_sharded_lookup(
                dmesh, cfg.tt_p_shapes, cfg.tt_q_shapes, cfg.tt_ranks)
            dstep = dlrm.make_dlrm_train_step(cfg, mesh=dmesh,
                                              learning_rate=DLRM_LR,
                                              device=cuda)

            def sharded():
                return dlrm.shard_dlrm_params(full, cfg, dmesh)

            with torch.no_grad():
                logits = all_gather_cat(dlrm.dlrm_forward(
                    sharded(), cfg, local[0], local[1], lookup))
                ref_logits = dlrm.dlrm_forward(full, cfg, batch[0], batch[1])
            zero_counts()
            with plain_watch() as plains:
                loss_a, pa = dstep(sharded(), *local)
                torch.cuda.synchronize()
            got = counts()
            res["launches"]["train_multi_dlrm"] = got
            loss_b, pb = dstep(sharded(), *local)
            same = torch.equal(loss_a, loss_b) and all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    leaves_with_paths(pa), leaves_with_paths(pb)))
            one_step = dlrm.make_dlrm_train_step(cfg, learning_rate=DLRM_LR,
                                                 device=cuda)
            loss_r, pr = one_step(map_leaves(torch.clone, full), *batch)
            mine = dlrm.shard_dlrm_params(pr, cfg, dmesh)
            old = sharded()
            lerr = abs(loss_a.item() - loss_r.item()) / abs(loss_r.item())
            gerr = (logits - ref_logits).abs().max().item()
            gscale = ref_logits.abs().max().item()
            least_cos = 1.0
            for (name, new), (_, r_new), (_, r_old) in zip(
                    leaves_with_paths(pa), leaves_with_paths(mine),
                    leaves_with_paths(old)):
                cos = torch.nn.functional.cosine_similarity(
                    (new - r_old).flatten(), (r_new - r_old).flatten(),
                    dim=0).item()
                least_cos = min(least_cos, cos)
                if not (torch.isfinite(new).all() and cos >= COS_MIN):
                    fail(f"{tag}: DLRM {name}'s update against one device's "
                         f"(cosine {cos:.6f})")
            print(f"{tag}: table-sharded DLRM (dp, mp) = (1, {world}) at "
                  f"DLRM_KW, global B={DLRM_B}: launches {launch_text(got)}, "
                  f"plain versions {plains or 0}; two runs bitwise equal "
                  f"{same}; loss {loss_a.item():.6f} against one device's "
                  f"{loss_r.item():.6f} (relative error {lerr:.3e}, limit "
                  f"{OUT_TOL}); logits max_abs_err {gerr:.3e} (limit "
                  f"{DLRM_LOGIT_TOL} x {gscale:.3e}); least cos(dp, "
                  f"dp_one_device) over this rank's leaves {least_cos:.6f} "
                  f"(limit {COS_MIN})", flush=True)
            if (plains or not got["seg_transform"] or not got["seg_accum"]
                    or not same or lerr > OUT_TOL
                    or gerr > DLRM_LOGIT_TOL * gscale):
                fail(f"{tag}: the DLRM step's launches, repeatability, loss "
                     "or logits")
            del pa, pb, pr, mine, old
            dscratch = sharded()
            res["times"]["dlrm"] = world_times(
                lambda: dstep(dscratch, *local))
            print(f"{tag}: DLRM step {times_of(res['times']['dlrm'])} "
                  f"[{card_line()}]", flush=True)
            del dscratch
            # the walkthrough on this world's mesh, at its full size
            zero_counts()
            with plain_watch() as plains:
                walk = train_dlrm.main(["--steps", "40", "--mesh",
                                        f"1,{world}", "--device", "cuda"])
            got = counts()
            res["launches"]["dlrm_walkthrough_mesh"] = got
            print(f"{tag}: examples.train_dlrm --steps 40 --mesh 1,{world}: "
                  f"loss {walk['first_loss']:.4f} -> {walk['last_loss']:.4f}, "
                  f"held-out AUC {walk['auc']:.4f} over the gathered logits; "
                  f"launches {launch_text(got)}, plain versions "
                  f"{plains or 0}", flush=True)
            if plains or not walk["last_loss"] < walk["first_loss"] \
                    or not got["seg_accum"]:
                fail(f"{tag}: the walkthrough on the mesh")
        multi_rest(fbt, tag, world, rank, mesh, cuda, zero_counts, counts,
                   res, cores_np, g_dout)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def add_launches(res, path, got):
    """Add one run's launches to ``res["launches"][path]``."""
    acc = res["launches"].setdefault(path, dict.fromkeys(got, 0))
    for k, v in got.items():
        acc[k] += v


def held(tag, what, got, want, tol, world, bitwise_at_one=True):
    """``got`` against ``want``: bitwise on a world of one (where
    ``bitwise_at_one``: the same computation), else within ``tol`` x
    max|want|; the text of the comparison, failing the run otherwise."""
    import torch

    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    if world == 1 and bitwise_at_one:
        if not torch.equal(got, want):
            fail(f"{tag}: {what} not bitwise equal to its twin's "
                 f"(max_abs_err {err:.3e})")
        return f"{what} bitwise equal to its twin's"
    if not (torch.isfinite(got).all() and err <= tol * scale):
        fail(f"{tag}: {what} max_abs_err {err:.3e} against {tol} x "
             f"{scale:.3e}")
    return f"{what} max_abs_err {err:.3e} (limit {tol} x {scale:.3e})"


def multi_rest(fbt, tag, world, rank, mesh, cuda, zero_counts, counts, res,
               cores_np, g_dout):
    """Phase 5e's checks of the data-parallel serve, the replicated-cache
    lookup, the table-owned step and the row-owned cache family on this
    rank (see the docstring); launches and times into ``res``."""
    import numpy as np
    import torch

    from fbtt_embedding_tpu_torch.parallel import host_local_slice

    bl = MULTI_B // world
    spec_b = (None, "dp")
    rng = np.random.default_rng(3)  # the same on every rank
    cores = fbt.params_from_jax(cores_np, device=cuda).tt_cores
    # the LFU cache as phase 4 counts it: 20 Zipf(1.05) batches of B=512,
    # cache_size E / 10 (rounded down to a multiple of the ranks)
    c_size = (E // 10) // world * world
    base = fbt.make_cache_state(E, c_size, D, num_embeddings=E, device=cuda)
    for _ in range(20):
        fbt.update_cache_state(base, torch.as_tensor(
            (rng.zipf(1.05, size=B * POOL) - 1) % E, device=cuda))
    rep = fbt.cache_populate(clone_cache(base), cores, P, Q, R)
    g_idx = ((rng.zipf(1.05, size=MULTI_B * POOL) - 1) % E).astype(
        np.int32).reshape(1, MULTI_B, POOL)
    idx_l = torch.tensor(host_local_slice(mesh, spec_b, g_idx), device=cuda)
    dout_l = torch.tensor(host_local_slice(mesh, spec_b, g_dout),
                          device=cuda)
    g_flat = torch.tensor(g_idx.reshape(-1), device=cuda)
    g_offs = torch.arange(0, MULTI_B * POOL + 1, POOL, device=cuda)
    hit = (fbt.cache_lookup(rep, idx_l.reshape(-1)) >= 0).float().mean(
    ).item()
    sprm = fbt.TTEmbeddingParams(cores, (), rep)
    mine = slice(rank * bl, (rank + 1) * bl)
    dlookup = fbt.make_dp_lookup(mesh, P, Q, R)

    # 4. the data-parallel serve: folded bf16 and int8, and not folded,
    # against the single-device serve of the same kind on the whole batch
    outs = {}
    for label, folded, quantize, path in (
            ("folded bf16", True, None, "serve_multi_dp"),
            ("folded int8", True, "int8", "serve_multi_dp_int8"),
            ("not folded", False, None, "serve_multi_dp")):
        fold, serve = fbt.make_dp_serving_fn(
            mesh, P, Q, R, 1, MULTI_B, POOL, folded=folded,
            quantize=quantize, device=cuda)
        fp = fold(sprm)
        if folded:
            tfold, tserve = fbt.make_folded_serving_fn(
                P, Q, R, 1, MULTI_B, quantize=quantize, device=cuda)
            tfp = tfold(sprm)

            def twin():
                return tserve(tfp, g_flat, g_offs)
        else:
            tserve = fbt.make_serving_fn(P, Q, R, 1, MULTI_B, device=cuda)

            def twin():
                return tserve(sprm, g_flat, g_offs)
        zero_counts()
        with plain_watch() as plains:
            out_a = serve(fp, idx_l)
            torch.cuda.synchronize()
        got = counts()
        add_launches(res, path, got)
        same = torch.equal(out_a, serve(fp, idx_l))
        line = held(tag, "output", out_a, twin()[:, mine], OUT_TOL, world)
        outs[label] = out_a
        others = {k: v for k, v in got.items() if k != "seg_transform"}
        b1_ok = got["seg_transform"] == 1 if folded \
            else got["seg_transform"] >= 1
        if plains or any(others.values()) or not b1_ok or not same:
            fail(f"{tag}: dp serve {label}: launches {got}, plain versions "
                 f"{plains}, repeatable {same}")
        t = world_times(lambda: serve(fp, idx_l), MULTI_CALLS)
        res["times"][f"serve {label}"] = t
        print(f"{tag}: dp serve {label}, global B={MULTI_B} ({bl} a rank) "
              f"pooling {POOL} Zipf 1.05 probing the populated cache "
              f"(cache_size {c_size}, hit rate {hit:.4f}): launches "
              f"{launch_text(got)}, plain versions {plains or 0}; two runs "
              f"bitwise equal {same}; against the single-device serve on "
              f"the whole batch: {line}; {times_of(t)} [{card_line()}]",
              flush=True)
        if label == "folded bf16":
            t1 = world_times(twin, MULTI_CALLS)
            res["times"]["serve single-device"] = t1
            print(f"{tag}: the single-device folded bf16 serve at B="
                  f"{MULTI_B} on this rank: {times_of(t1)} [{card_line()}]",
                  flush=True)
        del fp, twin
    scale = outs["folded bf16"].abs().max().item()
    err = (outs["folded int8"] - outs["folded bf16"]).abs().max().item()
    print(f"{tag}: dp serve int8 against bf16: max_abs_err {err:.3e} (limit "
          f"1e-2 x {scale:.3e})", flush=True)
    if not err <= 1e-2 * scale:
        fail(f"{tag}: the int8 dp serve against the bf16 one")

    # 5. the replicated-cache lookup against the dp lookup, right after
    # populate
    clook = fbt.make_dp_cached_lookup(mesh, P, Q, R, device=cuda)
    zero_counts()
    with plain_watch() as plains:
        out_a = clook(cores, rep, idx_l)
        torch.cuda.synchronize()
    got = counts()
    add_launches(res, "lookup_multi_dp_cached", got)
    same = torch.equal(out_a, clook(cores, rep, idx_l))
    line = held(tag, "output", out_a, dlookup(cores, idx_l), OUT_TOL, world,
                bitwise_at_one=False)
    if plains or not got["seg_transform"] or not same:
        fail(f"{tag}: the replicated-cache lookup's launches or "
             "repeatability")
    t = world_times(lambda: clook(cores, rep, idx_l), MULTI_CALLS)
    res["times"]["dp cached lookup"] = t
    print(f"{tag}: replicated-cache lookup, B={bl} a rank: launches "
          f"{launch_text(got)}, plain versions {plains or 0}; two runs "
          f"bitwise equal {same}; against make_dp_lookup: {line}; "
          f"{times_of(t)} [{card_line()}]", flush=True)

    # 6. the table-owned step at the DLRM walkthrough's width, mesh (1, n)
    dk = DLRM_KW
    tmesh = fbt.make_mesh((1, world), ("dp", "mp"), device_type="cuda")
    t8, pd, ld = dk["num_tables"], dk["tt_p_shapes"], dk["pooling_factor"]
    tcores = fbt.init_tt_cores(np.random.default_rng(4), "uniform", t8,
                               dk["num_embeddings"], D, pd, Q, R)
    t_idx = rng.integers(0, dk["num_embeddings"], size=(t8, DLRM_B, ld)
                         ).astype(np.int32)
    t_dout = rng.normal(size=(t8, DLRM_B, D)).astype(np.float32)
    t_offs = np.arange(0, t8 * DLRM_B * ld + 1, ld)
    idx_t = host_local_slice(tmesh, ("mp", "dp"), t_idx)
    dout_t = host_local_slice(tmesh, (None, ("dp", "mp")), t_dout)
    for optim, semantics in (("SGD", "reference"), ("ADAM", "native")):
        opt_t = fbt.OptimType[optim]

        def whole():
            prm = fbt.params_from_jax(tcores, device=cuda)
            prm.optimizer_state = (
                fbt.native_optim_init(opt_t, prm.tt_cores)
                if semantics == "native" else
                tuple(torch.zeros(0, device=cuda) for _ in prm.tt_cores))
            return prm

        def owned():
            return fbt.shard_table_sharded_params(tmesh, whole(), device=cuda)

        tstep = fbt.make_table_sharded_fused_train_step(
            tmesh, pd, Q, R, t8, DLRM_B, ld, optimizer=opt_t,
            optim_semantics=semantics, device=cuda)
        zero_counts()
        with plain_watch() as plains:
            out_a, pa = tstep(owned(), idx_t, dout_t, (LR, EPS))
            torch.cuda.synchronize()
        got = counts()
        add_launches(res, "train_multi_table_owned", got)
        out_b, pb = tstep(owned(), idx_t, dout_t, (LR, EPS))
        same = torch.equal(out_a, out_b) and all(
            torch.equal(a, b) for a, b in zip(pa.tt_cores + pa.optimizer_state,
                                              pb.tt_cores + pb.optimizer_state))
        one = fbt.make_fused_train_step(pd, Q, R, t8, DLRM_B, optimizer=opt_t,
                                        optim_semantics=semantics,
                                        device=cuda)
        ref_out, ref = one(whole(), t_idx.reshape(-1), t_offs, t_dout,
                           (LR, EPS))
        ref = fbt.shard_table_sharded_params(tmesh, ref, device=cuda)
        ref_out = host_local_slice(tmesh, (None, ("dp", "mp")), ref_out)
        old = owned()
        what = (f"{tag} table-owned {optim} step")
        line = (f"{tag}: table-owned {optim} ({semantics}) step, mesh (1, "
                f"{world}), {t8 // world} of {t8} tables of E="
                f"{dk['num_embeddings']} a rank, B={DLRM_B} pooling {ld}: "
                f"launches {launch_text(got)}, plain versions {plains or 0}; "
                f"two runs bitwise equal {same}")
        if world == 1:
            bit = torch.equal(out_a, ref_out) and all(
                torch.equal(a, b) for a, b in zip(
                    pa.tt_cores + pa.optimizer_state,
                    ref.tt_cores + ref.optimizer_state))
            line += f"; bitwise the single-device step's {bit}"
            if not bit:
                fail(f"{what}: not bitwise the single-device step")
        elif semantics == "native":
            line += "; " + held(tag, "output", out_a, ref_out, OUT_TOL, world)
            line = hold_cosine(line, pa, ref, old, what)
        else:
            line = hold_step(line, out_a, ref_out, pa, ref, old, OUT_TOL,
                             UPDATE_TOL, what)
        print(line, flush=True)
        if plains or not same or not got["seg_fused_i2"] \
                or not got["seg_accum"]:
            fail(f"{what}: launches or repeatability")
        if optim == "SGD":
            scratch = owned()
            t = world_times(lambda: tstep(scratch, idx_t, dout_t,
                                          (1e-4, EPS)), MULTI_CALLS)
            res["times"]["table-owned step"] = t
            print(f"{tag}: table-owned SGD step {times_of(t)} "
                  f"[{card_line()}]", flush=True)
        del pa, pb, ref, old

    # 7. the row-owned cache: populate, lookup and step against the
    # replicated cache
    owned_rep = fbt.shard_cache_weight_by_owner(mesh, rep.weight, device=cuda)
    populate = fbt.make_row_owned_populate(mesh, P, Q, R, c_size,
                                           device=cuda)
    zero_counts()
    with plain_watch() as plains:
        t0 = time.perf_counter()
        cnt, w_own, _ = populate(clone_cache(base), cores)
        torch.cuda.synchronize()
        pop_s = time.perf_counter() - t0
    got = counts()
    add_launches(res, "populate_multi_row_owned", got)
    _, w_again, _ = populate(clone_cache(base), cores)
    same = torch.equal(w_own, w_again)
    exact = all(torch.equal(getattr(cnt, f), getattr(rep, f))
                for f in ("keys", "freq", "slots"))
    err = (w_own - owned_rep).abs().max().item()
    wscale = owned_rep.abs().max().item()
    print(f"{tag}: row-owned populate, cache_size {c_size} ({c_size // world}"
          f" rows a rank): {pop_s:.2f} s; counting fields equal to "
          f"cache_populate's {exact}; owned rows max_abs_err {err:.3e} "
          f"against shard_cache_weight_by_owner of cache_populate's (limit "
          f"1e-5 x {wscale:.3e}); two runs bitwise equal {same}; launches "
          f"{launch_text(got) or 'none'} (populate decompresses by the plain "
          f"chain), plain versions {plains or 0}", flush=True)
    if not (exact and same and err <= 1e-5 * wscale):
        fail(f"{tag}: the row-owned populate")
    del w_again

    olook = fbt.make_row_owned_cached_lookup(mesh, P, Q, R, c_size,
                                             device=cuda)
    zero_counts()
    with plain_watch() as plains:
        out_a = olook(cores, cnt.slots, w_own, idx_l)
        torch.cuda.synchronize()
    got = counts()
    add_launches(res, "lookup_multi_row_owned", got)
    same = torch.equal(out_a, olook(cores, cnt.slots, w_own, idx_l))
    line = held(tag, "output", out_a, dlookup(cores, idx_l), OUT_TOL, world,
                bitwise_at_one=False)
    line2 = held(tag, "against the replicated-cache lookup", out_a,
                 clook(cores, rep, idx_l), 1e-6, world, bitwise_at_one=False)
    if plains or not got["seg_transform"] or not same:
        fail(f"{tag}: the row-owned lookup's launches or repeatability")
    t = world_times(lambda: olook(cores, cnt.slots, w_own, idx_l),
                    MULTI_CALLS)
    res["times"]["row-owned lookup"] = t
    print(f"{tag}: row-owned lookup, B={bl} a rank: launches "
          f"{launch_text(got)}, plain versions {plains or 0}; two runs "
          f"bitwise equal {same}; against make_dp_lookup: {line}; {line2}; "
          f"{times_of(t)} [{card_line()}]", flush=True)
    del cnt, w_own, owned_rep

    for optim, kind in (("SGD", "none"), ("EXACT_ADAGRAD", "full")):
        opt_t = fbt.OptimType[optim]
        opt0 = (tuple(torch.zeros(0, device=cuda) for _ in cores)
                if optim == "SGD" else tuple(torch.zeros_like(c)
                                             for c in cores))
        kpop = fbt.make_row_owned_populate(mesh, P, Q, R, c_size,
                                           opt_state_kind=kind, device=cuda)
        ostep = fbt.make_row_owned_fused_train_step(
            mesh, P, Q, R, c_size, MULTI_B, POOL, optimizer=opt_t,
            device=cuda)

        def owned_state():
            cnt, w0, o0 = kpop(clone_cache(base), cores)
            return (fbt.TTEmbeddingParams(
                tuple(c.clone() for c in cores),
                tuple(s.clone() for s in opt0), cnt), w0, o0)

        prm_o, w0, o0 = owned_state()
        w_old = w0.clone()
        zero_counts()
        with plain_watch() as plains:
            out_a, pa, wa, oa = ostep(prm_o, w0, o0, idx_l, dout_l, (LR, EPS))
            torch.cuda.synchronize()
        got = counts()
        add_launches(res, "train_multi_row_owned", got)
        out_b, pb, wb, ob = ostep(*owned_state(), idx_l, dout_l, (LR, EPS))
        same = (torch.equal(out_a, out_b) and torch.equal(wa, wb)
                and torch.equal(oa, ob) and torch.equal(pa.cache.freq,
                                                        pb.cache.freq)
                and all(torch.equal(a, b) for a, b in zip(pa.tt_cores,
                                                          pb.tt_cores)))
        rstate = clone_cache(base)
        if kind == "full":
            rstate.opt_state = torch.zeros((c_size, D), device=cuda)
        rstate = fbt.cache_populate(rstate, cores, P, Q, R)
        rstep = fbt.make_sharded_fused_train_step(
            mesh, P, Q, R, 1, MULTI_B, POOL, optimizer=opt_t, use_cache=True,
            probe_cache=True, device=cuda)
        rprm = fbt.TTEmbeddingParams(tuple(c.clone() for c in cores),
                                     tuple(s.clone() for s in opt0), rstate)
        r_old = fbt.TTEmbeddingParams(tuple(c.clone() for c in cores))
        out_r, pr = rstep(rprm, idx_l, dout_l, (LR, EPS))
        what = f"{tag} row-owned {optim} step"
        line = (f"{tag}: row-owned {optim} step against the replicated-cache "
                f"dp step, global B={MULTI_B} Zipf 1.05: launches "
                f"{launch_text(got)}, plain versions {plains or 0}; two runs "
                f"bitwise equal {same}")
        line = hold_step(line, out_a, out_r, pa, pr, r_old, OUT_TOL,
                         UPDATE_TOL, what)
        counts_equal = torch.equal(pa.cache.freq, pr.cache.freq)
        rows_rep = fbt.shard_cache_weight_by_owner(mesh, pr.cache.weight,
                                                   device=cuda)
        upd = (rows_rep - w_old).abs().max().item()
        rerr = (wa - rows_rep).abs().max().item()
        line += (f"; LFU counts equal {counts_equal}; owned rows' update "
                 f"max|d - d_rep| {rerr:.3e} (limit {UPDATE_TOL} x "
                 f"{upd:.3e})")
        ok = counts_equal and upd > 0 and rerr <= UPDATE_TOL * upd
        if kind == "full":
            o_rep = fbt.shard_cache_weight_by_owner(mesh, pr.cache.opt_state,
                                                    device=cuda)
            oscale = o_rep.abs().max().item()
            oerr = (oa - o_rep).abs().max().item()
            line += (f"; owned Adagrad state max_abs_err {oerr:.3e} (limit "
                     f"{UPDATE_TOL} x {oscale:.3e})")
            ok = ok and oerr <= UPDATE_TOL * oscale
        print(line, flush=True)
        if plains or not same or not ok or got["seg_fused_i2"] != 1 \
                or got["seg_accum"] != 1:
            fail(f"{what}: launches, repeatability, counts or owned rows")
        if optim == "SGD":
            sc = owned_state()
            t = world_times(lambda: ostep(*sc, idx_l, dout_l, (1e-4, EPS)),
                            MULTI_CALLS)
            res["times"]["row-owned step"] = t
            rsc = fbt.TTEmbeddingParams(tuple(c.clone() for c in cores),
                                        opt0, clone_cache(rep))
            # few calls: each all-reduces the [C, D] row gradients, and
            # one call pads the profiler's window well enough
            tr = world_times(lambda: rstep(rsc, idx_l, dout_l, (1e-4, EPS)),
                             n=2, pad=1)
            res["times"]["replicated-cache step"] = tr
            print(f"{tag}: row-owned SGD step {times_of(t)}; the "
                  f"replicated-cache dp step {times_of(tr)} [{card_line()}]",
                  flush=True)
            del sc, rsc
        del pa, pb, pr, rprm, rstate, wa, wb, oa, ob
    torch.cuda.empty_cache()


def multi_phase(card):
    """Phase 5e of the docstring: the worlds of ``multi_child``, one after
    the other on the card (world 1 on NCCL, world 2 on gloo), each child a
    fresh process (spawned, never forked), the kernels and the native
    loader built here first. Any child's failure fails the run. Returns
    the launches of the paths ``train_multi_dp``, ``train_multi_csr``
    (summed over the ranks of both worlds), ``train_multi_dlrm`` and
    ``dlrm_walkthrough_mesh`` (the world of 2)."""
    import tempfile

    from fbtt_embedding_tpu_torch import native

    t_phase = time.perf_counter()
    print(f"[multi] native loader built: {native.build()}", flush=True)
    paths = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        with tempfile.TemporaryDirectory() as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--multi-child", f"{world},{r},{backend},{init},{tmp}"])
                for r in range(world)]
            try:
                rcs = [p.wait(timeout=900) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(rcs):
                fail(f"phase 5e: a rank of the world of {world} ({backend}) "
                     f"failed: exit codes {rcs}")
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    res = json.load(f)
                for path, got in res["launches"].items():
                    acc = paths.setdefault(path, dict.fromkeys(got, 0))
                    for k, v in got.items():
                        acc[k] += v
    print(f"[multi] phase took {time.perf_counter() - t_phase:.1f} s; "
          f"launches summed over the ranks {paths} [{card}]", flush=True)
    return paths


def phase_mark(name, t_start):
    """A line with the seconds from ``t_start`` to the phase's start."""
    print(f"[phase] {name}: starts {time.perf_counter() - t_start:.1f} s "
          "into the run", flush=True)


def check_close(name, got, want, tol):
    """max |got - want| after asserting closeness at ``tol``."""
    import torch

    err = (got.float() - want.float()).abs().max().item() \
        if got.numel() else 0.0
    try:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    except AssertionError as e:
        fail(f"{name}: kernel disagrees with its plain version: {e}")
    return err


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np

    import fbtt_embedding_tpu_torch as fbt
    from fbtt_embedding_tpu_torch.ops.kernels import _build
    from fbtt_embedding_tpu_torch.utils import knobs
    from fbtt_embedding_tpu_torch.ops.kernels import tt_flat, tt_kernel
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum import (
        seg_accum,
        seg_accum_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_accum_dg0 import (
        PATH_NAMES as DG0_PATHS,
        dg0_path,
        dg0_takes,
        seg_accum_dg0,
        seg_accum_dg0_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_fused_i2 import (
        seg_fused_i2,
        seg_fused_i2_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels.seg_transform import (
        seg_transform,
        seg_transform_plain,
    )
    from fbtt_embedding_tpu_torch.ops.kernels import tt_bwd as tt_bwd_mod
    from fbtt_embedding_tpu_torch.ops.kernels import tt_fwd as tt_fwd_mod
    from fbtt_embedding_tpu_torch.ops.kernels.tt_bwd import tt_bwd, tt_bwd_plain
    from fbtt_embedding_tpu_torch.ops.kernels.tt_fwd import (
        chain_dims,
        tt_fwd,
        tt_fwd_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"seg_transform": seg_transform, "seg_fused_i2": seg_fused_i2,
                "seg_accum": seg_accum, "seg_accum_dg0": seg_accum_dg0,
                "tt_fwd": tt_fwd, "tt_bwd": tt_bwd}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"[device] torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    # the knobs as this process reads them (5a sets FBTT_PAIR and
    # FBTT_FUSED_APPLY, 5 and 5b-5d FBTT_DG0, each for its block only)
    print("[knobs] " + knobs.describe().replace("\n", "\n[knobs] "))

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    for stem in libs:
        _build.library(stem)
    print(f"[build] {len(libs)} kernel librar(ies) in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(str(p.relative_to(root)) for p in libs.values()))
    for stem, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {stem}: {line.strip()}")
    # the bf16 passes of B1 and B3 and the pivot passes of B4 and B5 run on
    # the tensor cores: HMMA in their SASS
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for stem in ("seg_transform", "seg_accum", "tt_fwd", "tt_bwd"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[stem])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        n_hmma = sum("HMMA" in line for line in sass.splitlines())
        print(f"[build] {stem} SASS ({cuobjdump.name} -sass): {n_hmma} HMMA "
              "instructions")
        if n_hmma == 0:
            fail(f"{stem}'s SASS holds no HMMA instruction")

    phase_mark("3 kernels vs plain", t_start)
    # 3. kernels vs plain
    rng = np.random.default_rng(0)
    seg = tt_flat.SEG
    f32_tol = dict(rtol=1e-5, atol=1e-5)
    bf16_tol = dict(rtol=8e-3, atol=1e-4)  # f32 sums rounded once: 1 ulp
    max_err = dict.fromkeys(wrappers, 0.0)
    f32, bf16 = torch.float32, torch.bfloat16
    plain_dt = ((f32, f32), (bf16, bf16))
    cases = [  # name, blocks, bw_in, bw_out, p_rows, nza, mm, (in, out)
        #        dtypes, the path bfloat16 must take
        ("headline i1", 4, 32, 128, 220, 10240, 1,
         plain_dt + ((bf16, f32),), "tensor cores"),
        ("headline i2", 4, 128, 16, 250, 10240, 1, plain_dt, None),
        ("ndim2 q=[8,8] r=[32]", 8, 32, 8, 1000, 4096, 1, plain_dt, None),
        ("ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90, 2048, 1,
         plain_dt, None),
        # the folds the pipeline passes (headline i2: G2 32 x 4 over 16
        # sub-blocks; tt_ndim 4: pass 2 32 x 128 over 16, pass 3 32 x 4
        # over 64, staged in chunks of rows)
        ("headline i2", 4, 128, 16, 250, 10240, 4,
         plain_dt + ((bf16, f32),), "narrow tensor cores"),
        ("ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90, 2048, 4,
         plain_dt, "tensor cores"),
        ("ndim4 q=[4]*4 r=[32]*3 pass 3", 4, 512, 64, 90, 2048, 16,
         plain_dt, "narrow tensor cores"),
    ]
    # every width of the narrow tensor-core path: a last core G[j] of rank
    # kx = 16, 32 or 64 by q ky = 2, 4 or 8, folded by 4, in bfloat16
    cases += [(f"last core rank {kx} q {ky}", 4, 4 * kx, 4 * ky, 250, 2048,
               4, ((bf16, bf16),), "narrow tensor cores")
              for kx in (16, 32, 64) for ky in (2, 4, 8)]
    for (name, blocks, bw_in, bw_out, p_rows, nza, mm, dtypes,
         want_path) in cases:
        name = f"{name} mm={mm}"
        for dtype, out_dtype in dtypes:
            runs, first, cnt, x, table = span_case(
                rng, nza, blocks, bw_in, bw_out, p_rows, dtype, seg, mm=mm)
            kw = dict(blocks=blocks, bw_in=bw_in, bw_out=bw_out,
                      p_rows=p_rows, seg=seg, out_dtype=out_dtype, mm=mm)
            y = seg_transform(runs, first, cnt, x, table, **kw)
            again = seg_transform(runs, first, cnt, x, table, **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                fail(f"seg_transform {name}: two runs differ (not bitwise "
                     "repeatable)")
            ref = seg_transform_plain(runs, first, cnt, x, table, **kw)
            tol = f32_tol if out_dtype == f32 else bf16_tol
            dead = runs[p_rows].item()
            if dead < nza and y[dead:].abs().max().item() != 0:
                fail(f"{name} {dtype}: sentinel rows are not zero")
            err = check_close(f"seg_transform {name}", y, ref, tol)
            max_err["seg_transform"] = max(max_err["seg_transform"], err)
            path = span_path("seg_transform", dtype, blocks, bw_in, bw_out,
                             mm)
            if want_path and dtype == bf16 and path != want_path:
                fail(f"seg_transform {name} bf16 takes the {path} path, not "
                     f"the {want_path}")
            print(f"[kernel] seg_transform {name} {str(dtype)[6:]} -> "
                  f"{str(out_dtype)[6:]} ({path}): max_abs_err {err:.3e} "
                  f"(rtol {tol['rtol']}, atol {tol['atol']}), bitwise "
                  "repeatable, ok")

    # B2 and B3 at the headline training passes (B3: i1 with float32 z as
    # in the fused step, i2 as in the two-pass backward) and at two wider
    # passes, on dense slabs (mm = 1) and on block-diagonal tables folded as
    # the pipeline folds them (mm > 1), twice each
    grad_cases = [  # kernel, name, blocks, bw_x, bw_y, p_rows, nza, mm
        ("seg_fused_i2", "headline i2", 4, 128, 16, 250, 10240, 1),
        ("seg_accum", "headline i1", 4, 32, 128, 220, 10240, 1),
        ("seg_accum", "headline i2", 4, 128, 16, 250, 10240, 1),
        # slabs past one 64 KB staging chunk: tt_ndim 4, ranks 32
        ("seg_fused_i2", "ndim4 q=[4]*4 r=[32]*3 pass 3", 4, 512, 64, 90,
         2048, 1),
        ("seg_accum", "ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90,
         2048, 1),
        # the folds the training step runs (headline i2: G2 32 x 4) and
        # those of a tt_ndim-4 model (pass 3: 32 x 4 over 16 sub-blocks;
        # pass 2: 32 x 128 over 4)
        ("seg_fused_i2", "headline i2", 4, 128, 16, 250, 10240, 4),
        ("seg_accum", "headline i2", 4, 128, 16, 250, 10240, 4),
        ("seg_fused_i2", "ndim4 q=[4]*4 r=[32]*3 pass 3", 4, 512, 64, 90,
         2048, 16),
        ("seg_accum", "ndim4 q=[4]*4 r=[32]*3 pass 3", 4, 512, 64, 90,
         2048, 16),
        ("seg_fused_i2", "ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90,
         2048, 4),
        ("seg_accum", "ndim4 q=[4]*4 r=[32]*3 pass 2", 4, 128, 512, 90,
         2048, 4),
    ]
    both = (torch.float32, torch.bfloat16)
    grad_cases = [(*c, both, None) for c in grad_cases]
    # every instantiation of the narrow tensor-core kernel: a last core G[j]
    # of rank kx = 16, 32 or 64 by q ky = 2, 4 or 8, folded by mm = 4, in
    # bfloat16, each required to take that path; and a fold the kernels
    # take only in part (rank 4: kx = 4 is below 8, so the wrapper folds by
    # 2 and adds the two diagonal blocks left in acc itself)
    for kname in ("seg_fused_i2", "seg_accum"):
        grad_cases += [(kname, f"last core rank {kx} q {ky}", 4, 4 * kx,
                        4 * ky, 250, 2048, 4, (torch.bfloat16,),
                        "narrow tensor cores")
                       for kx in (16, 32, 64) for ky in (2, 4, 8)]
        grad_cases.append((kname, "last core rank 4 q 4", 4, 16, 16, 250,
                           2048, 4, both, "folded by 2"))
    for (kname, name, blocks, bw_x, bw_y, p_rows, nza, mm, dtypes,
         want_path) in grad_cases:
        name = f"{name} mm={mm}"
        for dtype in dtypes:
            runs, first, cnt, x, y, table = span_case(
                rng, nza, blocks, bw_x, bw_y, p_rows, dtype, seg,
                y_width=bw_y, mm=mm)
            kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows,
                      seg=seg, mm=mm)
            variants = ([{}] if kname == "seg_fused_i2" else
                        [dict(z_dtype=torch.float32),
                         dict(z_dtype=torch.bfloat16)])
            for extra in variants:
                fn = wrappers[kname]
                ref_fn = (seg_fused_i2_plain if kname == "seg_fused_i2"
                          else seg_accum_plain)
                got = fn(runs, first, cnt, x, y, table, **kw, **extra)
                again = fn(runs, first, cnt, x, y, table, **kw, **extra)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"{kname} {name}: two runs differ (not bitwise "
                         "repeatable)")
                want = ref_fn(runs, first, cnt, x, y, table, **kw, **extra)
                dead = runs[p_rows].item()
                for out in got[1:]:
                    if dead < nza and out[dead:].abs().max().item() != 0:
                        fail(f"{kname} {name}: sentinel rows are not zero")
                errs = [check_close(f"{kname} {name} acc", got[0], want[0],
                                    f32_tol)]
                for g, w in zip(got[1:], want[1:]):
                    tol = f32_tol if g.dtype == torch.float32 else bf16_tol
                    errs.append(check_close(f"{kname} {name}", g, w, tol))
                max_err[kname] = max(max_err[kname], *errs)
                outs = "acc, z" + (", rows" if len(got) == 3 else "")
                zdt = str(got[1].dtype)[6:]
                path = span_path(kname, dtype, blocks, bw_x, bw_y, mm)
                if ((kname, name, dtype) == ("seg_accum", "headline i1 mm=1",
                                             torch.bfloat16)
                        and path != "tensor cores"):
                    fail(f"seg_accum {name} bf16 takes the {path} path, not "
                         "the tensor cores")
                if want_path and want_path not in path:
                    fail(f"{kname} {name} {dtype} takes the {path} path, "
                         f"not {want_path}")
                print(f"[kernel] {kname} {name} {str(dtype)[6:]} (z {zdt}, "
                      f"{path}):"
                      f" max_abs_err {outs} "
                      + ", ".join(f"{e:.3e}" for e in errs)
                      + " (acc rtol = atol = 1e-5; float32 outputs the same,"
                      " bfloat16 one ulp), bitwise repeatable, ok")

    # B6 at the headline i1 pass (uniform and Zipf(1.05) first-core rows),
    # a tt_ndim-4 first pass and two tables (tp0 = 2 * p0), twice each, on
    # the path its rule gives (bfloat16: the tensor cores with dz0 over y);
    # the headline's bfloat16 inputs also on the other two paths
    dg0_cases = [  # name, blocks, bw_x, bw_y, p_rows, nza, tp0, zipf i0
        ("headline i1", 4, 32, 128, 220, 10240, 200, False),
        ("headline i1, zipf1.05 i0", 4, 32, 128, 220, 10240, 200, True),
        ("ndim4 q=[4]*4 r=[32]*3 pass 1", 4, 32, 128, 60, 2048, 60, False),
        ("T=2 headline i1", 4, 32, 128, 440, 10240, 400, False),
    ]
    for name, blocks, bw_x, bw_y, p_rows, nza, tp0, zipf in dg0_cases:
        for dtype in (torch.float32, torch.bfloat16):
            bf16_in = dtype == torch.bfloat16
            runs, first, cnt, x, y, table = span_case(
                rng, nza, blocks, bw_x, bw_y, p_rows, dtype, seg,
                y_width=bw_y)
            args = (runs, first, cnt, x, y,
                    i0_rows(rng, runs, p_rows, nza, tp0, zipf), table)
            kw = dict(blocks=blocks, bw_x=bw_x, bw_y=bw_y, p_rows=p_rows,
                      tp0=tp0, seg=seg)
            path = dg0_path(bf16_in, seg, blocks, bw_x, bw_y, card=True)
            if bf16_in and name.startswith("headline") and path != 2:
                fail(f"seg_accum_dg0 {name} bf16 takes the "
                     f"{DG0_PATHS.get(path)} path, not the tensor cores with "
                     "dz0 over y")
            others = [p for p in DG0_PATHS if p != path and dg0_takes(
                p, bf16_in, seg, blocks, bw_x, bw_y)] \
                if (name, bf16_in) == ("headline i1", True) else []
            want = seg_accum_dg0_plain(*args, **kw)
            for p in [path] + others:
                got = seg_accum_dg0(*args, path=p, **kw)
                again = seg_accum_dg0(*args, path=p, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"seg_accum_dg0 {name} ({DG0_PATHS[p]}): two runs "
                         "differ (not bitwise repeatable)")
                errs = [check_close(f"seg_accum_dg0 {name} {out}", g, w,
                                    f32_tol)
                        for out, g, w in zip(("acc", "dG0"), got, want)]
                max_err["seg_accum_dg0"] = max(max_err["seg_accum_dg0"],
                                               *errs)
                print(f"[kernel] seg_accum_dg0 {name} {str(dtype)[6:]} (tp0 "
                      f"{tp0}, {DG0_PATHS[p]}"
                      f"{', the rule' if p == path else ''}): max_abs_err "
                      f"acc, dG0 {errs[0]:.3e}, {errs[1]:.3e} (rtol = atol = "
                      "1e-5), bitwise repeatable, ok")
    # B6's path rule: the library's answer and its Python copy agree
    for blocks, bw_x, bw_y, rseg, bf16_in in DG0_RULE_SHAPES:
        took = dg0_path(bf16_in, rseg, blocks, bw_x, bw_y, card=True)
        rule = dg0_path(bf16_in, rseg, blocks, bw_x, bw_y)
        if took != rule:
            fail(f"seg_accum_dg0 path rule, blocks={blocks} {bw_x} x {bw_y} "
                 f"seg={rseg} bf16={bf16_in}: the library says {took}, the "
                 f"Python copy {rule}")
    print(f"[kernel] seg_accum_dg0 path rule: the library and its Python copy "
          f"agree on {len(DG0_RULE_SHAPES)} shapes")

    # B4's and B5's path rules: the library's answers and their Python
    # copies (code on the CPU, the tests) agree on every shape of the CPU
    # tests' path cases, each way of the last core's product and each rule
    # of the tt_ndim-4 passes
    for kname, query in (("tt_fwd", tt_fwd_mod.fwd_path),
                         ("tt_bwd", tt_bwd_mod.bwd_path)):
        for q_, r_ in FWD_RULE_SHAPES:
            rk_ = tuple(tt_kernel.full_ranks(q_, r_))
            took, rule = query(q_, rk_, card=True), query(q_, rk_)
            if took != rule:
                fail(f"{kname} path rule, q={q_} ranks={r_}: the library "
                     f"says {took}, the Python copy {rule}")
        print(f"[kernel] {kname} path rule: the library and its Python copy "
              f"agree on {len(FWD_RULE_SHAPES)} shapes")

    # B4 and B5 in float32 on whole batches (the generic path has no
    # bfloat16 staging); each twice
    grad_tol = dict(rtol=1e-4, atol=1e-5)  # the JAX suite's, for gradients
    gen_cases = [  # name, p, q, inner ranks, B, pooling, tables, zipf,
        #            weights, live share, B4's and B5's path
        ("headline uniform", P, Q, R[1:-1], B, POOL, 1, False, False, None,
         "pivot"),
        ("headline zipf1.05", P, Q, R[1:-1], B, POOL, 1, True, False, None,
         "pivot"),
        ("ndim2 q=[8,8] r=[32]", [3300, 3300], [8, 8], [32], B, POOL, 1,
         False, False, None, "pivot"),
        ("ndim2 q=[8,8] r=[32] zipf1.05", [3300, 3300], [8, 8], [32], B, POOL,
         1, True, False, None, "pivot"),
        ("ndim4 q=[4]*4 r=[32]*3", [60] * 4, [4] * 4, [32] * 3, 64, 8, 1,
         False, False, None, "pivot"),
        # the billion-row tt_ndim-4 model at the headline batch
        ("ndim4 billion", P4, Q4, R4[1:-1], B, POOL, 1, False, False, None,
         "pivot"),
        ("ndim4 billion zipf1.05", P4, Q4, R4[1:-1], B, POOL, 1, True, False,
         None, "pivot"),
        # tt_ndim 4 on the chain passes (r_1 not a multiple of 8)
        ("ndim4 q=[4]*4 r=[12,8,8]", [60] * 4, [4] * 4, [12, 8, 8], 64, 8, 1,
         True, True, None, "chain"),
        ("rank 64", P, Q, [64, 64], B, POOL, 1, False, False, None, "pivot"),
        ("T=2 weighted", P, Q, R[1:-1], 128, POOL, 2, False, True, None,
         "pivot"),
        ("live-count tail", P, Q, R[1:-1], 256, POOL, 1, True, True, 0.75,
         "pivot"),
        # B4's last-core product on the CUDA cores (q_0 q_1 = 12, r_2 = 8)
        ("ndim3 q=[3,4,5] r=[16,8]", [60] * 3, [3, 4, 5], [16, 8], 128, 8, 1,
         True, True, None, "pivot"),
    ]
    for name, p_, q_, r_, b_, pool, tables, zipf, wts, live, path in \
            gen_cases:
        gk, gidx, rowv, wv, order, starts, sched, dout = generic_inputs(
            rng, p_, q_, r_, b_, pool, tables, zipf, wts, live)
        qk, rk = chain_dims(gk)
        # the library's path queries, as the launches ask them, and their
        # Python copies for the CPU
        for kname, mod in (("tt_fwd", tt_fwd_mod), ("tt_bwd", tt_bwd_mod)):
            query = getattr(mod, "fwd_path" if kname == "tt_fwd"
                            else "bwd_path")
            took, rule = query(qk, rk, card=True), query(qk, rk)
            if took[0] != path or took != rule:
                fail(f"{kname} {name}: takes the {took[0]} pass (chunk, CTAs "
                     f"an SM: {took[1:]}; the Python rule says {rule}), "
                     f"expected {path}")
        # the pivot orders (core 1's; at tt_ndim 4 cores 1 and 2), as the
        # step's forward builds them for both kernels
        core1 = tuple(x[1:3] for x in sched[:2])
        out = tt_fwd(gk, gidx, rowv, wv, order, starts, core1=core1)
        out2 = tt_fwd(gk, gidx, rowv, wv, order, starts, core1=core1)
        g1 = tt_bwd(gk, gidx, rowv, wv, dout, *sched, seg=tt_kernel.SEG)
        g2 = tt_bwd(gk, gidx, rowv, wv, dout, *sched, seg=tt_kernel.SEG)
        torch.cuda.synchronize()
        if not torch.equal(out, out2):
            fail(f"tt_fwd {name}: two runs differ (not bitwise repeatable)")
        if not torch.equal(out, tt_fwd(gk, gidx, rowv, wv, order, starts)):
            fail(f"tt_fwd {name}: differs where the wrapper sorts core 1 "
                 "itself")
        if not all(torch.equal(a, c) for a, c in zip(g1, g2)):
            fail(f"tt_bwd {name}: two runs differ (not bitwise repeatable)")
        ferr = check_close(f"tt_fwd {name}", out,
                           tt_fwd_plain(gk, gidx, rowv, wv, order, starts),
                           f32_tol)
        want = tt_bwd_plain(gk, gidx, rowv, wv, dout, *sched,
                            seg=tt_kernel.SEG)
        gerrs = [check_close(f"tt_bwd {name} core {t}", a, c, grad_tol)
                 for t, (a, c) in enumerate(zip(g1, want))]
        max_err["tt_fwd"] = max(max_err["tt_fwd"], ferr)
        max_err["tt_bwd"] = max(max_err["tt_bwd"], *gerrs)
        print(f"[kernel] tt_fwd / tt_bwd {name} (nnz {gidx.shape[1]}, "
              f"{int((rowv < 0).sum())} dead; B4 "
              f"{tt_fwd_mod.fwd_path(qk, rk, card=True)[:2]}, B5 "
              f"{tt_bwd_mod.bwd_path(qk, rk, card=True)[:2]}, (pass, "
              f"chunk)): max_abs_err forward {ferr:.3e} (rtol = atol = "
              "1e-5), core gradients "
              + ", ".join(f"{e:.3e}" for e in gerrs)
              + " (rtol 1e-4, atol 1e-5), both bitwise repeatable, ok")

    phase_mark("4 serve", t_start)
    # 4. serve at full width
    cores = fbt.init_tt_cores(np.random.default_rng(0), "uniform", 1, E, D,
                              P, Q, R)
    params = fbt.params_from_jax(cores, device="cuda")
    serve = fbt.make_serving_fn(P, Q, R, 1, B, device="cuda")
    serve_big = fbt.make_serving_fn(P, Q, R, 1, 2 * B, device="cuda")
    plain = fbt.make_serving_fn(P, Q, R, 1, B, impl="xla", device="cuda")
    plain_big = fbt.make_serving_fn(P, Q, R, 1, 2 * B, impl="xla",
                                    device="cuda")
    req_rng = np.random.default_rng(1)

    def request(b, zipf):
        n = b * POOL
        if zipf:
            idx = (req_rng.zipf(1.05, size=n) - 1) % E
        else:
            idx = req_rng.integers(0, E, size=n)
        return (torch.as_tensor(idx, device="cuda"),
                torch.arange(0, n + 1, POOL, device="cuda"))

    requests = [(B, z) + request(B, z)
                for z in (False, True, False, True, False)]
    requests.append((2 * B, False) + request(2 * B, False))
    torch.cuda.synchronize()

    outs = []
    zero_counts()
    for b, _, idx, offs in requests:
        before = seg_transform.launches
        out = (serve if b == B else serve_big)(params, idx, offs)
        outs.append(out)
        want = 2 if b == B else 1
        if seg_transform.launches - before != want:
            fail(f"B={b}: {seg_transform.launches - before} kernel launches,"
                 f" expected {want}")
    torch.cuda.synchronize()
    serve_launches = counts()
    for (b, zipf, idx, offs), out in zip(requests, outs):
        ref = (plain if b == B else plain_big)(params, idx, offs)
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"B={b}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        mode = "pair" if b != B else "two-pass"
        print(f"[serve] B={b} pooling {POOL} "
              f"{'zipf1.05' if zipf else 'uniform'} ({mode}): max_abs_err "
              f"{err:.3e} vs plain f32, limit {OUT_TOL * scale:.3e} "
              f"({OUT_TOL} x max|out| {scale:.3e})")
        if not err <= OUT_TOL * scale:
            fail(f"B={b}: serve disagrees with the plain path")
    print(f"[serve] launches on the serving path: {serve_launches}")

    # the generic path: impl="pallas", kernel B4 once per request
    gserve = fbt.make_serving_fn(P, Q, R, 1, B, impl="pallas", device="cuda")
    greqs = [r for r in requests if r[0] == B][:2]  # uniform, Zipf
    zero_counts()
    gouts = []
    for b, _, idx, offs in greqs:
        before = counts()
        gouts.append(gserve(params, idx, offs))
        got = {k: v - before[k] for k, v in counts().items()}
        if got != {**dict.fromkeys(wrappers, 0), "tt_fwd": 1}:
            fail(f"serve impl='pallas' B={b}: launches {got}, expected "
                 "tt_fwd 1 and nothing else")
    torch.cuda.synchronize()
    gserve_launches = counts()
    for (b, zipf, idx, offs), out in zip(greqs, gouts):
        ref = plain(params, idx, offs)
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"serve impl='pallas' B={b}: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        print(f"[serve] impl='pallas' B={b} pooling {POOL} "
              f"{'zipf1.05' if zipf else 'uniform'}: max_abs_err {err:.3e} "
              f"vs plain f32, limit {F32_OUT_TOL * scale:.3e} "
              f"({F32_OUT_TOL} x max|out| {scale:.3e}); launches B4 1, B1 0")
        if not err <= F32_OUT_TOL * scale:
            fail(f"serve impl='pallas' B={b}: disagrees with the plain path")
    print(f"[serve] launches on the impl='pallas' serving path: "
          f"{gserve_launches}")

    # the LFU cache at the reference benchmark's setting (bench.py
    # --cached): direct mode, hashtbl_size = E, cache_size = 0.1 E, full
    # Adagrad state; counted on 20 Zipf(1.05) batches of B=512, populated
    t0 = time.perf_counter()
    cache = fbt.make_cache_state(E, E // 10, D, "full", num_embeddings=E,
                                 device="cuda")
    counted = [request(B, True)[0] for _ in range(20)]
    for ids in counted:
        fbt.update_cache_state(cache, ids)
    want_freq = torch.bincount(torch.cat(counted), minlength=E)
    if not torch.equal(cache.freq.long(), want_freq):
        fail("direct-mode LFU counts differ from torch.bincount")
    cache = fbt.cache_populate(cache, params.tt_cores, P, Q, R)
    torch.cuda.synchronize()
    n_cached = int((cache.slots >= 0).sum())
    print(f"[cache] direct mode E={E}, cache_size {E // 10}: counted "
          f"{len(counted)} Zipf(1.05) batches of {B * POOL} lookups (counts "
          f"equal torch.bincount), populated {n_cached} rows in "
          f"{time.perf_counter() - t0:.2f} s")
    cserve = fbt.make_serving_fn(P, Q, R, 1, B, device="cuda")
    cplain = fbt.make_serving_fn(P, Q, R, 1, B, impl="xla", device="cuda")
    cprm = fbt.TTEmbeddingParams(params.tt_cores, (), cache)
    creqs = [request(B, True) for _ in range(2)]
    zero_counts()
    couts = []
    for idx, offs in creqs:
        before = seg_transform.launches
        couts.append(cserve(cprm, idx, offs))
        if seg_transform.launches - before != 2:
            fail("cached serve: B1 not twice per request")
    torch.cuda.synchronize()
    cserve_launches = counts()
    for (idx, offs), out in zip(creqs, couts):
        ref = cplain(cprm, idx, offs)
        hit = (fbt.cache_lookup(cache, idx) >= 0).float().mean().item()
        if out.shape != (1, B, D) or not torch.isfinite(out).all():
            fail(f"cached serve: bad output {tuple(out.shape)}")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item()
        print(f"[serve] probe_cache B={B} pooling {POOL} zipf1.05, hit rate "
              f"{hit:.4f}: max_abs_err {err:.3e} vs plain f32, limit "
              f"{OUT_TOL * scale:.3e} ({OUT_TOL} x max|out| {scale:.3e}); "
              "launches B1 2")
        if not (0 < hit < 1 and err <= OUT_TOL * scale):
            fail("cached serve: disagrees with the plain path, or the "
                 "request had no hit or no miss")
    print(f"[serve] launches on the cache-probing serving path: "
          f"{cserve_launches}")

    phase_mark("4b folded", t_start)
    # 4b. the folded serve at full width
    folded_launches, int8_launches = folded_phase(
        fbt, card, wrappers, params, serve, cache, cserve, request)

    phase_mark("4c pool", t_start)
    # 4c. pools above 4096 rows
    pool_phase(fbt, card, params)

    phase_mark("5 train", t_start)
    # 5. train at full width
    def clone(prm):
        return fbt.TTEmbeddingParams(
            tuple(c.clone() for c in prm.tt_cores),
            tuple(s_.clone() for s_ in prm.optimizer_state), None)

    def train_batch(b, zipf):
        idx, offs = request(b, zipf)
        d_out = torch.as_tensor(req_rng.standard_normal((1, b, D)),
                                dtype=torch.float32, device="cuda")
        return idx, offs, d_out

    sgd_steps = {b: fbt.make_fused_train_step(P, Q, R, 1, b, device="cuda")
                 for b in (B, 2 * B, 4 * B)}
    sgd_plain = {b: fbt.make_fused_train_step(
        P, Q, R, 1, b, impl="xla", precision="highest", device="cuda")
        for b in (B, 2 * B, 4 * B)}
    ada = fbt.OptimType.EXACT_ADAGRAD
    ada_step = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                         device="cuda")
    ada_plain = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                          impl="xla", precision="highest",
                                          device="cuda")
    expect = {  # launches per step: (B1, B2, B3)
        "fused": (1, 1, 1), "fused, pair": (0, 1, 1), "autograd": (1, 0, 2)}
    plan = [(B, z, "sgd", "fused")
            for z in (False, True, False, True, False)]
    plan += [(2 * B, False, "sgd", "fused, pair"),
             (4 * B, False, "sgd", "autograd"), (B, False, "adagrad",
                                                 "fused")]
    batches = [train_batch(b, z) for b, z, _, _ in plan]
    tparams = fbt.params_from_jax(cores, device="cuda")
    aparams = None
    torch.cuda.synchronize()
    train_launches = dict.fromkeys(wrappers, 0)
    for (b, zipf, opt, path), (idx, offs, d_out) in zip(plan, batches):
        if opt == "adagrad":
            state = [torch.zeros_like(c) for c in tparams.tt_cores]
            aparams = fbt.TTEmbeddingParams(
                tuple(c.clone() for c in tparams.tt_cores), tuple(state),
                None)
            prm, kstep, pstep = aparams, ada_step, ada_plain
        else:
            prm, kstep, pstep = tparams, sgd_steps[b], sgd_plain[b]
        old = clone(prm)
        zero_counts()
        out, new = kstep(prm, idx, offs, d_out, (LR, EPS))
        torch.cuda.synchronize()
        got = counts()
        ref_out, ref = pstep(clone(old), idx, offs, d_out, (LR, EPS))
        for k in wrappers:
            train_launches[k] += got[k]
        want = {**dict.fromkeys(wrappers, 0), **dict(zip(
            ("seg_transform", "seg_fused_i2", "seg_accum"), expect[path]))}
        if got != want:
            fail(f"train B={b} ({path}): launches {got}, expected {want}")
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"train B={b}: bad output {tuple(out.shape)}")
        line = (f"[train] {opt} B={b} pooling {POOL} "
                f"{'zipf1.05' if zipf else 'uniform'} ({path}): launches "
                f"B1 {got['seg_transform']} B2 {got['seg_fused_i2']} "
                f"B3 {got['seg_accum']}")
        print(hold_step(line, out, ref_out, new, ref, old, OUT_TOL,
                        UPDATE_TOL, f"train B={b} {opt}"))
        if opt != "adagrad":
            tparams = new
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    if tf32 != (False, "highest"):
        fail(f"TF32 is on after training: allow_tf32, precision = {tf32}")
    print(f"[train] TF32 off: matmul.allow_tf32 {tf32[0]}, float32 matmul "
          f"precision {tf32[1]!r}")
    print(f"[train] launches on the training path: {train_launches}")

    # the generic path: impl="pallas", B4 forward and B5 backward, float32
    gsteps = {b: fbt.make_fused_train_step(P, Q, R, 1, b, impl="pallas",
                                           device="cuda") for b in (B, 4 * B)}
    gada = fbt.make_fused_train_step(P, Q, R, 1, B, optimizer=ada,
                                     impl="pallas", device="cuda")
    gplan = [(B, False, "sgd"), (B, True, "sgd"), (4 * B, False, "sgd"),
             (B, False, "adagrad")]
    gbatches = [train_batch(b, z) for b, z, _ in gplan]
    gparams = fbt.params_from_jax(cores, device="cuda")
    per_step = {**dict.fromkeys(wrappers, 0), "tt_fwd": 1, "tt_bwd": 1}
    torch.cuda.synchronize()
    gtrain_launches = dict.fromkeys(wrappers, 0)
    for (b, zipf, opt), (idx, offs, d_out) in zip(gplan, gbatches):
        if opt == "adagrad":
            prm = fbt.TTEmbeddingParams(
                tuple(c.clone() for c in gparams.tt_cores),
                tuple(torch.zeros_like(c) for c in gparams.tt_cores), None)
            kstep, pstep = gada, ada_plain
        else:
            prm, kstep, pstep = gparams, gsteps[b], sgd_plain[b]
        old = clone(prm)
        zero_counts()
        out, new = kstep(prm, idx, offs, d_out, (LR, EPS))
        torch.cuda.synchronize()
        got = counts()
        ref_out, ref = pstep(clone(old), idx, offs, d_out, (LR, EPS))
        for k in wrappers:
            gtrain_launches[k] += got[k]
        if got != per_step:
            fail(f"train impl='pallas' B={b}: launches {got}, expected "
                 f"{per_step}")
        if out.shape != (1, b, D) or not torch.isfinite(out).all():
            fail(f"train impl='pallas' B={b}: bad output {tuple(out.shape)}")
        line = (f"[train] impl='pallas' {opt} B={b} pooling {POOL} "
                f"{'zipf1.05' if zipf else 'uniform'}: launches B4 "
                f"{got['tt_fwd']} B5 {got['tt_bwd']}, B1-B3 0")
        print(hold_step(line, out, ref_out, new, ref, old, F32_OUT_TOL,
                        F32_UPDATE_TOL, f"train impl='pallas' B={b} {opt}"))
        if opt != "adagrad":
            gparams = new
    print(f"[train] launches on the impl='pallas' training path: "
          f"{gtrain_launches}")

    phase_mark("5 generic tt_ndim 4", t_start)
    g4_launches = generic4_phase(fbt, card, wrappers)

    # the reference benchmark's step: (a) five SGD steps with LFU counting
    # on (direct mode, hashtbl_size = E, cache_size = 0.1 E)
    flat3 = {**dict.fromkeys(wrappers, 0), "seg_transform": 1,
             "seg_fused_i2": 1, "seg_accum": 1}
    count_step = fbt.make_fused_train_step(P, Q, R, 1, B, use_cache=True,
                                           device="cuda")
    cparams = fbt.TTEmbeddingParams(
        fbt.params_from_jax(cores, device="cuda").tt_cores, (),
        fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                             device="cuda"))
    cbatches = [train_batch(B, z) for z in (False, True, False, True, False)]
    ctrain_launches = dict.fromkeys(wrappers, 0)

    def run_checked(kstep, pstep, prm, batch, want, label, tols, cached):
        """One kernel step and the plain step from a copy of the same params
        (and cache); launches, output, cores and cache checked."""
        old = clone(prm)
        old_cache = clone_cache(prm.cache) if cached else None
        zero_counts()
        out, new = kstep(prm, *batch, (LR, EPS))
        torch.cuda.synchronize()
        got = counts()
        ref_prm = clone(old)
        if cached:
            ref_prm.cache = clone_cache(old_cache)
        ref_out, ref = pstep(ref_prm, *batch, (LR, EPS))
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")
        b_ = batch[0].shape[0] // POOL
        if out.shape != (1, b_, D) or not torch.isfinite(out).all():
            fail(f"{label}: bad output {tuple(out.shape)}")
        line = (f"[train] {label}: launches B1 {got['seg_transform']} B2 "
                f"{got['seg_fused_i2']} B3 {got['seg_accum']} B6 "
                f"{got['seg_accum_dg0']}")
        line = hold_step(line, out, ref_out, new, ref, old, *tols, label)
        if cached:
            line = hold_cache(line, new.cache, ref.cache, old_cache, label)
        print(line)
        return got, new

    for i, batch in enumerate(cbatches):
        got, cparams = run_checked(
            count_step, sgd_plain[B], cparams, batch, flat3,
            f"sgd B={B} pooling {POOL} counting step {i}",
            (OUT_TOL, UPDATE_TOL), False)
        for k in wrappers:
            ctrain_launches[k] += got[k]
    want_freq = torch.bincount(torch.cat([b_[0] for b_ in cbatches]),
                               minlength=E)
    if not torch.equal(cparams.cache.freq.long(), want_freq):
        fail("the counting step's LFU counts differ from torch.bincount")
    print(f"[train] LFU counts after {len(cbatches)} counting steps equal "
          f"torch.bincount of the traffic ({int(want_freq.sum())} lookups)")

    # (b) the --cached step: the populated cache probed, SGD and
    # EXACT_ADAGRAD (full state), against the plain step with the same cache
    csteps = {}
    for opt, optim in (("sgd", fbt.OptimType.SGD), ("adagrad", ada)):
        csteps[opt] = tuple(fbt.make_fused_train_step(
            P, Q, R, 1, B, optimizer=optim, use_cache=True, probe_cache=True,
            device="cuda", **extra)
            for extra in ({}, dict(impl="xla", precision="highest")))
    zbatches = [train_batch(B, True) for _ in range(3)]
    hit_rates = [(fbt.cache_lookup(cache, b_[0]) >= 0).float().mean().item()
                 for b_ in zbatches]
    for opt in ("sgd", "adagrad"):
        state = (tuple(torch.zeros_like(c) for c in tparams.tt_cores)
                 if opt == "adagrad" else ())
        prm = fbt.TTEmbeddingParams(
            tuple(c.clone() for c in tparams.tt_cores), state,
            clone_cache(cache))
        for i, batch in enumerate(zbatches[:2]):
            got, prm = run_checked(
                *csteps[opt], prm, batch, flat3,
                f"{opt} B={B} pooling {POOL} zipf1.05 cached step {i} (hit "
                f"rate {hit_rates[i]:.4f})", (OUT_TOL, UPDATE_TOL), True)
            for k in wrappers:
                ctrain_launches[k] += got[k]
    # the cache-row update is bitwise repeatable (sorted index_put_)
    loc = fbt.cache_lookup(cache, zbatches[2][0])
    rowidx2, _ = fbt.rowidx_from_offsets(zbatches[2][1], B * POOL, 1, B)
    rep_w = []
    for _ in range(2):
        c2 = clone_cache(cache)
        fbt.cache_backward_sgd(c2, zbatches[2][2], loc, rowidx2, LR)
        rep_w.append(c2.weight)
    if not torch.equal(*rep_w):
        fail("cache_backward_sgd: two runs differ (not bitwise repeatable)")
    print("[train] cache-row SGD update bitwise repeatable over two runs "
          f"({int((loc >= 0).sum())} hits)")
    print(f"[train] launches on the cached training path: {ctrain_launches}")

    # (c) FBTT_DG0=fused: B6 replaces B3 on the i1 pass
    dtrain_launches = dict.fromkeys(wrappers, 0)
    with knob({"FBTT_DG0": "fused"}):
        dplan = [  # step, plain step, batch, (B1, B2, B3, B6), label
            (sgd_steps[B], sgd_plain[B], cbatches[0], (1, 1, 0, 1),
             f"FBTT_DG0=fused sgd B={B} (fused)", False),
            (sgd_steps[2 * B], sgd_plain[2 * B], batches[5], (0, 1, 0, 1),
             f"FBTT_DG0=fused sgd B={2 * B} (fused, pair)", False),
            (sgd_steps[4 * B], sgd_plain[4 * B], batches[6], (1, 0, 1, 1),
             f"FBTT_DG0=fused sgd B={4 * B} (autograd)", False),
            (csteps["sgd"][0], csteps["sgd"][1], zbatches[2], (1, 1, 0, 1),
             f"FBTT_DG0=fused sgd B={B} cached", True),
        ]
        for kstep, pstep, batch, want, label, cached in dplan:
            prm = fbt.params_from_jax(cores, device="cuda")
            if cached:
                prm.cache = clone_cache(cache)
            want = {**dict.fromkeys(wrappers, 0), **dict(zip(
                ("seg_transform", "seg_fused_i2", "seg_accum",
                 "seg_accum_dg0"), want))}
            got, _ = run_checked(kstep, pstep, prm, batch, want, label,
                                 (OUT_TOL, UPDATE_TOL), cached)
            for k in wrappers:
                dtrain_launches[k] += got[k]
    print(f"[train] launches on the FBTT_DG0=fused training path: "
          f"{dtrain_launches}")

    phase_mark("5a knobs", t_start)
    # 5a. FBTT_PAIR and FBTT_FUSED_APPLY: launches, limits, repeats; the
    # card's A/B of both gates
    knob_launches = knob_phase(fbt, card, wrappers, cores, train_batch,
                               sgd_plain)

    phase_mark("5b module", t_start)
    # 5b. the modules at full width
    module_launches = module_phase(fbt, card, wrappers, request, count_step)

    phase_mark("5c native+wide", t_start)
    # 5c. the native optimizers and the wide-key cache
    nw_launches = native_wide_phase(fbt, card, wrappers, request, cores,
                                    cache, count_step)

    phase_mark("5d dlrm+tools", t_start)
    # 5d. the DLRM trainer and the tools
    dt_launches = dlrm_tools_phase(fbt, card, wrappers)

    phase_mark("5e multi", t_start)
    # 5e. multi-GPU: data-parallel worlds of 1 (NCCL) and 2 (gloo) ranks
    multi_launches = multi_phase(card)

    phase_mark("6 times", t_start)
    # 6. times. B1 on the inputs the B=512 uniform and Zipf(1.05) serves
    # hand it, beside one torch._grouped_mm call on the same inputs; the
    # uniform one's times go into the kernels' line
    idx, offs = requests[0][2], requests[0][3]
    dt = torch.bfloat16
    tcores = fbt.params_from_jax(cores, device="cuda").tt_cores
    g0f, _, tables, widths = tt_flat._flat_setup(tcores, P, Q, R, dt)
    times = {}
    for label, (ridx, roffs) in (("uniform", requests[0][2:4]),
                                 ("zipf1.05", requests[1][2:4])):
        rrow, _ = fbt.rowidx_from_offsets(roffs, ridx.shape[0], 1, B)
        rplan, _ = tt_flat._build_plan(ridx, rrow, None, None, None, P, 1, B,
                                       seg=seg)
        x = tt_flat._z0(rplan, g0f, P[0])
        for ti in (1, 2):
            mm, bw_in, bw_out = widths[ti - 1]
            span = (rplan.runs[ti - 1], rplan.first[ti - 1],
                    rplan.cnt[ti - 1])
            args = span + (x, tables[ti - 1])
            kw = dict(blocks=Q[0], bw_in=bw_in, bw_out=bw_out, p_rows=P[ti],
                      seg=seg, out_dtype=dt, mm=mm)
            t = kernel_times(lambda: seg_transform(*args, **kw),
                             lambda: seg_transform_plain(*args, **kw))
            t["bound_ms"], t["bound_by"] = pass_bound(
                span[0], span[1].numel(), x, Q[0], bw_in, bw_out, P[ti], dt,
                mm)
            y = seg_transform(*args, **kw)
            t["library_ms"] = None
            call, note = grouped_mm_call(span[0], x, tables[ti - 1], Q[0],
                                         bw_in, bw_out, P[ti], mm)
            lib = f"torch._grouped_mm not measured ({note})"
            if call is not None:
                got = call().reshape(y.shape)
                lerr = (got.float() - y.float()).abs().max().item()
                if torch.allclose(got.float(), y.float(), **bf16_tol):
                    t["library_ms"] = cuda_ms(call)
                    lib = (f"torch._grouped_mm {t['library_ms'] * 1e3:.2f} "
                           f"us between events, "
                           f"{device_ms(call)[0] * 1e3:.2f} us on the device "
                           f"({note}; max_abs_err {lerr:.3e} vs the kernel)")
                else:
                    lib = (f"torch._grouped_mm disagrees with the kernel "
                           f"(max_abs_err {lerr:.3e}): not timed ({note})")
            if label == "uniform":
                times.setdefault("seg_transform", []).append(t)
            path = span_path("seg_transform", dt, Q[0], bw_in, bw_out, mm)
            print(f"[time] seg_transform pass i{ti}, {label} batch (x "
                  f"{tuple(x.shape)} bf16, bw {bw_in}->{bw_out}, mm {mm}, "
                  f"{path}): {times_text(t)}; {lib} [{card}]")
            if ti == 1:
                x = y[rplan.perm_fwd[0].long()]

    # the training step's B2 (i2) and B3 (i1, float32 z), on a uniform and
    # a Zipf(1.05) B=512 batch (the first two serve requests); the uniform
    # one's times go into the kernels' line
    d_out = batches[0][2]
    for label, (ridx, roffs) in (("uniform", requests[0][2:4]),
                                 ("zipf1.05", requests[1][2:4])):
        rrow, _ = fbt.rowidx_from_offsets(roffs, ridx.shape[0], 1, B)
        rplan, _ = tt_flat._build_plan(ridx, rrow, None, None, None, P, 1, B,
                                       seg=seg)
        z0 = tt_flat._z0(rplan, g0f, P[0])
        _, bw_in, bw_out = widths[0]
        x1 = seg_transform(
            rplan.runs[0], rplan.first[0], rplan.cnt[0], z0, tables[0],
            blocks=Q[0], bw_in=bw_in, bw_out=bw_out, p_rows=P[1], seg=seg,
            out_dtype=dt)[rplan.perm_fwd[0].long()]
        dz = tt_flat._row_cotangents(d_out, rplan, B, D, dt)
        i0c = tt_flat._i0c(rplan, P[0])
        for kname, ti in (("seg_fused_i2", 2), ("seg_accum", 1),
                          ("seg_accum_dg0", 1)):
            mm, bw_x, bw_y = widths[ti - 1]
            xs, ys = (x1, dz) if ti == 2 else (z0, dz)
            args = (rplan.runs[ti - 1], rplan.first[ti - 1],
                    rplan.cnt[ti - 1], xs, ys, tables[ti - 1])
            kw = dict(blocks=Q[0], bw_x=bw_x, bw_y=bw_y, p_rows=P[ti],
                      seg=seg)
            if kname != "seg_accum_dg0":  # the fold the step passes
                kw["mm"] = mm
            if kname == "seg_accum":
                kw["z_dtype"] = torch.float32
            if kname == "seg_accum_dg0":  # i0c goes before the table
                args = args[:5] + (i0c,) + args[5:]
                kw["tp0"] = P[0]
                path = DG0_PATHS[dg0_path(dt == torch.bfloat16, seg, Q[0],
                                          bw_x, bw_y, card=True)]
            fn = wrappers[kname]
            ref_fn = {"seg_fused_i2": seg_fused_i2_plain,
                      "seg_accum": seg_accum_plain,
                      "seg_accum_dg0": seg_accum_dg0_plain}[kname]
            t = kernel_times(lambda: fn(*args, **kw),
                             lambda: ref_fn(*args, **kw))
            t["bound_ms"], t["bound_by"] = grad_pass_bound(
                rplan.runs[ti - 1], rplan.first[ti - 1].numel(), xs, Q[0],
                bw_x, bw_y, P[ti], kw.get("z_dtype", dt),
                kname == "seg_fused_i2",
                P[0] if kname == "seg_accum_dg0" else 0, kw.get("mm", 1))
            if kname == "seg_accum_dg0":
                t["path"] = path
            if label == "uniform":
                times[kname] = [t]
            if kname == "seg_fused_i2":  # dZ1, s2 -> s1: B3's y
                dz = fn(*args, **kw)[1][rplan.perm_bwd[0].long()]
            print(f"[time] {kname} pass i{ti}, {label} batch (x "
                  f"{tuple(xs.shape)}, y {tuple(ys.shape)} bf16, bw "
                  f"{bw_x}x{bw_y}, mm {kw.get('mm', 1)}"
                  + (f", {t['path']}" if "path" in t else "")
                  + f"): {times_text(t)} [{card}]")

    # an older tree's B1, B2, B3 and B6 beside these, where one is unpacked in
    # build/ab_old: the same inputs, a process per run, in turns old, new,
    # new, old
    ab_root = root / "build" / "ab_old"
    if (ab_root / "fbtt_embedding_tpu_torch").is_dir():
        ab = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            run = subprocess.run(
                [sys.executable, str(root / "scripts" / "time_span_kernels.py"),
                 "--root", str(ab_root if which == "old" else root)],
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                fail(f"time_span_kernels.py on the {which} tree exited "
                     f"{run.returncode}: {run.stderr[-3000:]}")
            ab[which].append(json.loads(run.stdout.splitlines()[-1]))

        def parts_text(run, name, label):
            return " + ".join(f"{k} {v:.2f}"
                              for k, v in run["parts"][name][label].items())

        def clocks_text(runs, name, label):
            return " / ".join(str(r["sm_mhz"][name][label]) for r in runs)

        for name, by_batch in ab["new"][0]["us"].items():
            for label in by_batch:
                old = [r["us"][name][label] for r in ab["old"]]
                new = [r["us"][name][label] for r in ab["new"]]
                print(f"[ab] {name} {label} batch, device us per call: "
                      f"{ab_root.name} {old[0]:.2f} / {old[1]:.2f} "
                      f"({parts_text(ab['old'][0], name, label)}), this tree "
                      f"{new[0]:.2f} / {new[1]:.2f} "
                      f"({parts_text(ab['new'][0], name, label)}): "
                      f"{sum(old) / sum(new):.2f}x; SM MHz "
                      f"{clocks_text(ab['old'], name, label)} against "
                      f"{clocks_text(ab['new'], name, label)} [{card}]")
        # B4 and B5 of both trees on the generic cases, in turns old, new,
        # new, old (scripts/check_generic_kernels.py checks each run too)
        gab = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            run = subprocess.run(
                [sys.executable,
                 str(root / "scripts" / "check_generic_kernels.py"), "--root",
                 str(ab_root if which == "old" else root)],
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                fail(f"check_generic_kernels.py on the {which} tree exited "
                     f"{run.returncode}: {run.stdout[-2000:]}"
                     f"{run.stderr[-2000:]}")
            gab[which].append(json.loads(run.stdout.splitlines()[-1]))
        for name, new0 in gab["new"][0]["cases"].items():
            olds = [r["cases"][name] for r in gab["old"]]
            news = [r["cases"][name] for r in gab["new"]]
            for kname, key, mkey in (("B4", "tt_fwd_us", "tt_fwd_mhz"),
                                     ("B5", "tt_bwd_us", "tt_bwd_mhz")):
                old_us = [c[key] for c in olds]
                new_us = [c[key] for c in news]
                mhz = " against ".join(" / ".join(str(c[mkey]) for c in cs)
                                       for cs in (olds, news))
                stem = key[:-3]
                print(f"[ab] {kname} {name}, device us per call: "
                      f"{ab_root.name} {old_us[0]:.2f} / {old_us[1]:.2f}, "
                      f"this tree {new_us[0]:.2f} / {new_us[1]:.2f} "
                      f"({new0[stem + '_path']} pass: " + " + ".join(
                          f"{k} {v:.2f}" for k, v in
                          new0[stem + "_parts"].items()) + ")"
                      + f": {sum(old_us) / sum(new_us):.2f}x; SM MHz {mhz} "
                      f"[{card}]")
    else:
        print(f"[ab] no older tree in {ab_root.relative_to(root)}: span "
              "and generic kernels not timed against it")

    serve_ms = host_ms(lambda: serve(params, idx, offs))
    big_ms = host_ms(lambda: serve_big(params, *requests[-1][2:]))
    print(f"[time] serve B={B} pooling {POOL}: {serve_ms:.3f} ms/request, "
          f"{serve_ms * 1e3 / idx.shape[0]:.4f} us/lookup [{card}]")
    print(f"[time] serve B={2 * B} pooling {POOL} (pair mode): "
          f"{big_ms:.3f} ms/request, "
          f"{big_ms * 1e3 / requests[-1][2].shape[0]:.4f} us/lookup [{card}]")

    # the training step per call; a small learning rate keeps the repeated
    # in-place updates of a scratch copy of the params finite
    scratch = fbt.params_from_jax(cores, device="cuda")
    step_ms = {}
    for (b, _, _, path), batch in list(zip(plan, batches))[4:7]:
        step = sgd_steps[b]
        ms = host_ms(lambda: step(scratch, *batch, (1e-4, EPS)))
        step_ms[b] = ms
        print(f"[time] train step SGD B={b} pooling {POOL} ({path}): "
              f"{ms:.3f} ms/step, {ms * 1e3 / (b * POOL):.4f} us/lookup "
              f"[{card}]")
    # the generic kernels on a uniform and a Zipf(1.05) headline batch;
    # the uniform one's times go into the kernels' line
    for label, zipf in (("uniform", False), ("zipf1.05", True)):
        gk, gidx, rowv, wv, order, starts, sched, dout = generic_inputs(
            np.random.default_rng(2), P, Q, R[1:-1], B, POOL, zipf=zipf)
        fargs = (gk, gidx, rowv, wv, order, starts)
        bargs = (gk, gidx, rowv, wv, dout, *sched)
        # core 1's order as the step builds it: its sort is not timed
        fkw = dict(core1=tuple(x[1:3] for x in sched[:2]))
        kseg = dict(seg=tt_kernel.SEG)
        for kname, fn, ref_fn, args, kw, query in (
                ("tt_fwd", tt_fwd, tt_fwd_plain, fargs, fkw,
                 tt_fwd_mod.fwd_path),
                ("tt_bwd", tt_bwd, tt_bwd_plain, bargs, kseg,
                 tt_bwd_mod.bwd_path)):
            t = kernel_times(lambda: fn(*args, **kw),
                             lambda: ref_fn(*args, **kw), 5, 3)
            backward = kname == "tt_bwd"
            t["bound_ms"], t["bound_by"] = generic_bound(
                gk, gidx, rowv, wv, B, backward)
            # the pivot passes run their products as 3xTF32 on the tensor
            # cores: their bound is that of three TF32 products, the
            # float32 CUDA-core bound beside it
            t["path"] = query(*chain_dims(gk), card=True)[0]
            bound_f32_ms = t["bound_ms"]
            if t["path"] == "pivot":
                t["bound_ms"], t["bound_by"] = generic_bound(
                    gk, gidx, rowv, wv, B, backward, tf32x3=True)
            extra = (f"; {t['path']} pass, bound at the float32 "
                     f"CUDA-core peak {bound_f32_ms * 1e3:.2f} us")
            if label == "uniform":
                times[kname] = [t]
            print(f"[time] {kname} headline B={B} pooling {POOL} {label} "
                  f"(nnz {gidx.shape[1]}, float32): {times_text(t)}{extra} "
                  f"[{card}]")
    # and on the billion-row tt_ndim-4 model's batches: the uniform one's
    # times go into the kernels' line as each row's "ndim4"
    for label, zipf in (("uniform", False), ("zipf1.05", True)):
        gk, gidx, rowv, wv, order, starts, sched, dout = generic_inputs(
            np.random.default_rng(2), P4, Q4, R4[1:-1], B, POOL, zipf=zipf)
        fargs = (gk, gidx, rowv, wv, order, starts)
        bargs = (gk, gidx, rowv, wv, dout, *sched)
        fkw = dict(core1=tuple(x[1:3] for x in sched[:2]))
        kseg = dict(seg=tt_kernel.SEG)
        for kname, fn, ref_fn, args, kw, query in (
                ("tt_fwd", tt_fwd, tt_fwd_plain, fargs, fkw,
                 tt_fwd_mod.fwd_path),
                ("tt_bwd", tt_bwd, tt_bwd_plain, bargs, kseg,
                 tt_bwd_mod.bwd_path)):
            t = kernel_times(lambda: fn(*args, **kw),
                             lambda: ref_fn(*args, **kw), 5, 3)
            backward = kname == "tt_bwd"
            bound_f32_ms = generic_bound(gk, gidx, rowv, wv, B, backward)[0]
            t["bound_ms"], t["bound_by"] = generic_bound(
                gk, gidx, rowv, wv, B, backward, tf32x3=True)
            t["path"] = query(*chain_dims(gk), card=True)[0]
            if t["path"] != "pivot":
                fail(f"{kname} tt_ndim-4 {label}: takes the {t['path']} "
                     "pass, expected pivot")
            if label == "uniform":
                times[kname][0]["ndim4"] = {
                    k: t[k] for k in ("ms", "plain_ms", "device_ms",
                                      "plain_device_ms", "bound_ms",
                                      "bound_by", "path")}
            print(f"[time] {kname} tt_ndim-4 p={P4} q={Q4} ranks "
                  f"{R4[1:-1]} B={B} pooling {POOL} {label} (nnz "
                  f"{gidx.shape[1]}, float32): {times_text(t)}; pivot path, "
                  f"bound at the float32 CUDA-core peak "
                  f"{bound_f32_ms * 1e3:.2f} us [{card}]")

    gserve_ms = host_ms(lambda: gserve(params, idx, offs))
    print(f"[time] serve impl='pallas' B={B} pooling {POOL}: {gserve_ms:.3f} "
          f"ms/request, {gserve_ms * 1e3 / idx.shape[0]:.4f} us/lookup (flat "
          f"path {serve_ms:.3f} ms) [{card}]")
    gbatch = gbatches[0]
    gstep = gsteps[B]
    gstep_ms = host_ms(lambda: gstep(scratch, *gbatch, (1e-4, EPS)))
    print(f"[time] train step SGD impl='pallas' B={B} pooling {POOL}: "
          f"{gstep_ms:.3f} ms/step, {gstep_ms * 1e3 / (B * POOL):.4f} "
          f"us/lookup (flat path {step_ms[B]:.3f} ms) [{card}]")
    print(f"[time] reference: the published fbtt figure, fwd+bwd with fused "
          f"SGD at B={B} pooling {POOL} on a V100 (BASELINE.md): "
          f"{V100_US_PER_LOOKUP} us/lookup (another card; not measured here)")

    # the reference benchmark's step (LFU counting on), the cached step,
    # and the counting step with FBTT_DG0 onehot against fused, in turns
    cscratch = fbt.TTEmbeddingParams(
        fbt.params_from_jax(cores, device="cuda").tt_cores, (),
        fbt.make_cache_state(E, E // 10, D, num_embeddings=E,
                             device="cuda"))
    cbatch = cbatches[4]
    count_ms = host_ms(lambda: count_step(cscratch, *cbatch, (1e-4, EPS)))
    print(f"[time] train step SGD B={B} pooling {POOL} with LFU counting "
          f"(direct, hashtbl_size {E}, cache_size {E // 10}): {count_ms:.3f} "
          f"ms/step, {count_ms * 1e3 / (B * POOL):.4f} us/lookup (reference "
          f"on a V100: {V100_US_PER_LOOKUP} us/lookup; without counting "
          f"{step_ms[B]:.3f} ms) [{card}]")
    hscratch = fbt.TTEmbeddingParams(
        fbt.params_from_jax(cores, device="cuda").tt_cores, (),
        clone_cache(cache))
    cached_ms = host_ms(lambda: csteps["sgd"][0](hscratch, *zbatches[0],
                                                 (1e-4, EPS)))
    print(f"[time] train step SGD B={B} pooling {POOL} zipf1.05, counting and "
          f"probing the populated cache (hit rate {hit_rates[0]:.4f}): "
          f"{cached_ms:.3f} ms/step, {cached_ms * 1e3 / (B * POOL):.4f} "
          f"us/lookup [{card}]")
    ab = {"onehot": [], "fused": []}
    for mode in ("onehot", "fused", "fused", "onehot"):
        with knob({"FBTT_DG0": mode}):
            ab[mode].append(host_ms(lambda: count_step(
                cscratch, *cbatch, (1e-4, EPS))))
    print(f"[time] counting step B={B} FBTT_DG0 A/B, in turns onehot, fused, "
          f"fused, onehot: onehot {ab['onehot'][0]:.3f} / "
          f"{ab['onehot'][1]:.3f} ms, fused {ab['fused'][0]:.3f} / "
          f"{ab['fused'][1]:.3f} ms [{card}]")

    free, _ = torch.cuda.mem_get_info()
    need = E * D * 4
    if free > 3 * need:
        bag = torch.nn.EmbeddingBag(E, D, mode="sum", include_last_offset=True,
                                    device="cuda")
        with torch.no_grad():
            bag_ms = host_ms(lambda: bag(idx, offs))
        print(f"[time] nn.EmbeddingBag({E}, {D}, sum) forward B={B} pooling "
              f"{POOL}: {bag_ms:.3f} ms/request, "
              f"{bag_ms * 1e3 / idx.shape[0]:.4f} us/lookup [{card}]")
        del bag
        sbag = torch.nn.EmbeddingBag(E, D, mode="sum", sparse=True,
                                     include_last_offset=True, device="cuda")
        opt = torch.optim.SGD(sbag.parameters(), lr=1e-4)
        tidx, toffs, tdout = batches[4]

        def bag_step():
            opt.zero_grad(set_to_none=True)
            sbag(tidx, toffs).backward(tdout[0])
            opt.step()

        bag_train_ms = host_ms(bag_step)
        print(f"[time] nn.EmbeddingBag({E}, {D}, sum, sparse) forward + "
              f"backward + SGD step B={B} pooling {POOL}: "
              f"{bag_train_ms:.3f} ms/step, "
              f"{bag_train_ms * 1e3 / tidx.shape[0]:.4f} us/lookup [{card}]")
        del sbag, opt
    else:
        print(f"[time] nn.EmbeddingBag yardsticks: not measured "
              f"({free / 2**30:.1f} GiB free, needs {3 * need / 2**30:.1f})")

    by_path = dict(zip(PATHS, (serve_launches, train_launches,
                               gserve_launches, gtrain_launches,
                               *g4_launches.values(),
                               cserve_launches, ctrain_launches,
                               dtrain_launches, knob_launches,
                               module_launches,
                               folded_launches, int8_launches,
                               *nw_launches.values(),
                               *dt_launches.values(),
                               *(multi_launches[k] for k in MULTI_PATHS))))
    kernels = []
    for name, rows in times.items():
        src, replaces = KERNELS[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {path: c[name] for path, c in
                                 by_path.items()},
            "max_abs_err": max_err[name],
            **{k: sum(r[k] for r in rows) for k in (
                "ms", "plain_ms", "device_ms", "plain_device_ms",
                "bound_ms")},
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in rows) else "operations"),
            "library_ms": (sum(r["library_ms"] for r in rows)
                           if all(r.get("library_ms") is not None
                                  for r in rows) else None),
            **({"path": rows[0]["path"]} if "path" in rows[0] else {}),
            **({"ndim4": rows[0]["ndim4"]} if "ndim4" in rows[0] else {}),
        })
    print(f"[phase] all phases took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-child"]:
        sys.exit(multi_child(sys.argv[2]))
    sys.exit(main())
