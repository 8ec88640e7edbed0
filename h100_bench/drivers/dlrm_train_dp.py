"""Driver of the traffic kind ``dlrm_train_dp``: the DLRM-DCNv2 training
step data-parallel over the ``ranks`` cards of one host.

The configuration and the mix are ``dlrm_train``'s (``drivers/
dlrm_train.py``, whose helpers this driver loads and does not change),
with ``ranks`` in the mix; ``batch_size`` is a rank's block. Batch ``k``
of the pool is the one-card driver's batch at ``ranks * batch_size``
samples, a function of the seed alone, and rank ``r`` trains its samples
``[r B, (r + 1) B)``. Every rank makes the same weights from the seed and
steps them with ``models/dcnv2.py::make_dcnv2_train_step(...,
group=WORLD)``, which sums the gradients over the ranks.

Rank 0 runs in the harness's process and does the timing, the tracing and
the check. It starts ranks 1.. first thing, as this file run as a script
(``--child``; one card each, ``parallel.initialize_distributed``: NCCL on
the card, gloo on the CPU). Every failure ends the world: a rank that
exits with an error makes rank 0 kill the others and exit; rank 0 kills
them when it raises; a rank whose rank 0 is gone (its stdin closed)
exits; and a collective that waits longer than ``TIMEOUT_S`` raises.

Set-up is ``dlrm_train``'s (the first step kept for the check, then
``WARM_STEPS``); rank 0 times the last ``TIMED_STEPS`` of them and fixes
from that the window's step count, which it sends to every rank, so that
every rank issues the same collectives and no signal crosses the window.
``train_us_per_lookup`` counts every rank's lookups: window s x 1e6 /
(steps x ranks x batch_size x lookups a sample). ``memory_peak_bytes`` is
the largest rank's. On the card every rank must hold a card of its own, of
rank 0's kind, or the run fails; ``harness.execute`` writes ``count`` 1
into every result's ``device``, so this driver has the one result that
``harness.emit`` prints next count the cards its ranks ran on. A traced run profiles rank 0 over a fixed count of
steps between untimed ones (``trace.read_profile``'s record).

``correct`` holds the first step against the plain float32 reference's
one step on the whole global batch (its gradient the mean of its blocks'
means, each block a rank's, so that it fits): ``logit_err`` over every
rank's logits, gathered; ``change_gap`` over rank 0's weights, as
``dlrm_train`` holds them; and ``replica_gap``: after the window, the
largest difference between rank 0's and another rank's copy of any leaf
or optimizer state, over the largest element of rank 0's. A missing sum
fails the last two. ``dlrm_train``'s ``grad_gap`` is left out: over the
global batch the gradient of the top MLP is a sum of 65,536 random-label
terms that cancel, and the bfloat16 tower's rounding moves its norm by
up to a quarter on sound seeds (PERF.md section 4).

``ctx.control``: the reference's global step staged in the precision
below the configuration's takes the program's place, on rank 0 alone.
``ctx.fault``: ``dlrm_train``'s ``frozen``, ``half_batch`` and
``tables_swapped`` on every rank, and ``rank_local``: the step without a
process group, so each rank updates with its own block's gradients.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":   # a rank started by rank 0
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from h100_bench import checks, roofline, spec, trace  # noqa: E402

base = spec.driver("dlrm_train")
ref = base.ref

WARM_STEPS, TIMED_STEPS = 7, 5   # after the first step; the last timed
TIMEOUT_S = 120                  # the longest a collective waits
POLL_S = 0.2                     # how often rank 0 looks at the others


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spawn(ctx, rank, world, url):
    arg = json.dumps({
        "rank": rank, "world": world, "url": url, "seed": ctx.seed,
        "seconds": ctx.seconds, "trace": ctx.trace,
        "device": ctx.device.type, "fault": ctx.fault,
        "config": ctx.config, "mix": ctx.mix})
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "FBTT_COORDINATOR", "FBTT_NUM_PROCESSES",
              "FBTT_PROCESS_ID"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, __file__, "--child", arg],
                            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                            env=env, cwd=str(spec.ROOT))


def _watch(children, done: threading.Event) -> None:
    """Rank 0's watch: a rank that exits with an error ends the world."""
    while not done.wait(POLL_S):
        for r, p in enumerate(children, 1):
            if p.poll() not in (None, 0) and not done.is_set():
                print(f"rank {r} exited with code {p.returncode}: ending "
                      "the world", file=sys.stderr, flush=True)
                for q in children:
                    if q.poll() is None:
                        q.kill()
                os._exit(1)


def _reference_step(model, rspec, batch, blocks, lr, eps, opt, stage=None):
    """One step of the reference on the global ``batch`` in place: its
    gradient the mean of its ``blocks`` equal blocks' (each the mean over
    its samples). Returns the logits."""
    dense, sparse, labels, _ = batch
    b = dense.shape[0] // blocks
    total, logits = None, []
    for k in range(blocks):
        s = slice(k * b, (k + 1) * b)
        _, out, g = ref.grads(model, rspec, (dense[s], [x[s] for x in sparse],
                                             labels[s], None), stage)
        logits.append(out)
        total = g if total is None else base._tmap(torch.add, total, g)
        del g
    state = ref.init_state(model)
    ref.update(model, state, base._tmap(lambda t: t / blocks, total), lr,
               eps, opt)
    return torch.cat(logits)


def _values(prog_logits, prog_w1, model0, ref_batch, ctx, rspec) -> dict:
    mix = ctx.mix
    ref_w1 = base._clone(model0)
    ref_logits = _reference_step(
        ref_w1, rspec, ref_batch, mix["ranks"], mix["learning_rate"],
        mix["eps"], mix["optimizer"])
    return {
        "logit_err": base.logit_err(prog_logits, ref_logits),
        "change_gap": checks.norm_gap(
            base.parts(base._tmap(torch.sub, prog_w1, model0)),
            base.parts(base._tmap(torch.sub, ref_w1, model0))),
    }


def _control(ctx) -> dict:
    """The reference staged in ``control_stage`` in the program's place."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    dense, labels, ids = base.make_batches(
        cfg, dict(mix, batch_size=mix["ranks"] * mix["batch_size"]),
        ctx.seed, mix["pool_batches"], dev)
    ref_batch = (dense[0], [x[0] for x in ids], labels[0], None)
    rspec = base.reference_spec(cfg, mix)
    model0 = base.make_weights(cfg, ctx.seed, dev)
    prog_w1 = base._clone(model0)
    logits = _reference_step(
        prog_w1, rspec, ref_batch, mix["ranks"], mix["learning_rate"],
        mix["eps"], mix["optimizer"], stage=cfg["control_stage"])
    res = {"attempted": 0, "failed": 0, "e2e": {}, "rec": None,
           "setup_s": time.perf_counter() - ctx.t_start,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    t_check = time.perf_counter()
    res["values"] = dict(_values(logits, prog_w1, model0, ref_batch, ctx,
                                 rspec), replica_gap=None)
    res["check_s"] = time.perf_counter() - t_check
    return res


def _traced(call, pad, steps, on_start):
    """Rank 0's profile: ``pad`` untimed steps, ``steps`` between the two
    marker kernels, ``pad`` more (``trace.traced_window``'s, at counts
    fixed beforehand, so that the other ranks issue as many steps)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            call()
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        on_start()
        for _ in range(steps):
            call()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        for _ in range(pad):
            call()
        torch.cuda.synchronize()
    return trace.read_profile(prof.events(), steps)


def _replica_gap(leaves, dev) -> torch.Tensor:
    """This rank's largest gap to rank 0's copy of ``leaves``, each over
    the largest element of rank 0's (a device scalar; 0 on rank 0)."""
    worst = torch.zeros((), device=dev)
    for t in leaves:
        r0 = t.detach().clone()
        dist.broadcast(r0, 0)
        gap = (t - r0).abs().max() / r0.abs().max()
        worst = torch.maximum(worst, torch.nan_to_num(gap, nan=0.0))
    return worst


def _cards(dev, world: int) -> list:
    """The cards the ranks run on, in rank order; fails unless each rank
    has a card of its own, of rank 0's kind."""
    mine = torch.tensor([dev.index], device=dev)
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    cards = [int(t.item()) for t in every]
    kinds = {torch.cuda.get_device_name(c) for c in cards}
    if len(set(cards)) != world or len(kinds) != 1:
        raise RuntimeError(f"the {world} ranks ran on cards {cards} "
                           f"({sorted(kinds)}): each needs a card of its "
                           "own, all of one kind")
    return cards


def _report_cards(count: int) -> None:
    """Have the next result ``harness.emit`` prints count ``count`` cards
    in its ``device``, where ``harness.execute`` writes 1."""
    from h100_bench import harness

    emit = harness.emit

    def emit_world(result, *args, **kwargs):
        harness.emit = emit
        result["device"]["count"] = count
        return emit(result, *args, **kwargs)

    harness.emit = emit_world


def _rank(ctx, rank: int, world: int, url: str):
    """One rank's part of the run; rank 0 returns the driver's result."""
    from fbtt_embedding_tpu_torch.models import dcnv2 as dc
    from fbtt_embedding_tpu_torch.parallel import initialize_distributed

    cuda = ctx.device.type == "cuda"
    if cuda and rank == 0:   # build before the others join, once
        from fbtt_embedding_tpu_torch.ops.kernels import _build
        _build.build_all()
    initialize_distributed(url, world, rank, device=ctx.device.type,
                           timeout_s=TIMEOUT_S)
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
               else ctx.device)
        return _steps(ctx, dc, rank, world, dev)
    finally:
        dist.destroy_process_group()


def _steps(ctx, dc, rank, world, dev):
    cfg, mix = ctx.config, ctx.mix
    lead = rank == 0
    cards = _cards(dev, world) if dev.type == "cuda" else None
    bsz, n_pool = mix["batch_size"], mix["pool_batches"]
    lr, eps, opt = mix["learning_rate"], mix["eps"], mix["optimizer"]
    dcfg = base.model_config(dc, cfg, mix)
    offsets = dcfg.plain_offsets
    nnz = bsz * dcfg.lookups()
    dense, labels, ids = base.make_batches(
        cfg, dict(mix, batch_size=world * bsz), ctx.seed, n_pool, dev)
    ref_batch = ((dense[0].clone(), [x[0].clone() for x in ids],
                  labels[0].clone(), None) if lead else None)
    blk = slice(rank * bsz, (rank + 1) * bsz)
    dense, labels = dense[:, blk].clone(), labels[:, blk].clone()
    ids = [x[:, blk].clone() for x in ids]
    weights = None
    if ctx.fault == "half_batch":
        weights = tuple(torch.ones((bsz, n), device=dev)
                        for n in mix["multi_hot"])
        for f in dcfg.tt_features:
            weights[f][bsz // 2:] = 0
    model0 = base.make_weights(cfg, ctx.seed, dev)
    params = base.program_params(dc, model0, opt)
    if not lead:
        del model0
    if ctx.fault == "tables_swapped":
        for c in params.tt_cores:
            c[[-2, -1]] = c[[-1, -2]].clone()
    step = dc.make_dcnv2_train_step(
        dcfg, bsz, optimizer=opt, learning_rate=lr, eps=eps, device=dev,
        impl=cfg["impl"],
        group=None if ctx.fault == "rank_local" else dist.group.WORLD)
    state = {"params": params, "k": 0}
    traced = ctx.trace and lead

    def call():
        k = state["k"] % n_pool
        p = state["params"]
        saved = ([t.clone() for t in dc.trainable_leaves(p)
                  + list(p.optimizer_state)]
                 if ctx.fault == "frozen" else None)
        with trace.span("step", traced):
            _, logits, state["params"] = step(p, dc.DCNv2Batch(
                dense[k], tuple(x[k] for x in ids), labels[k], weights))
        if saved is not None:
            now = dc.trainable_leaves(p) + list(p.optimizer_state)
            for t, s in zip(now, saved):
                t.copy_(s)
        state["k"] += 1
        return logits

    logits1 = call().clone()
    if lead:
        prog_w1 = base.reference_layout(dc, params, offsets)
    for _ in range(WARM_STEPS - TIMED_STEPS):
        call()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        call()
    _sync(dev)
    per_step = max((time.perf_counter() - t0) / TIMED_STEPS, 1e-6)
    window = min(ctx.seconds, trace.TRACE_SECONDS) if ctx.trace \
        else ctx.seconds
    counts = torch.tensor([
        max(1, round(window / per_step)), max(1, math.ceil(
            trace.PAD_S / per_step))], device=dev)
    dist.broadcast(counts, 0)
    n_steps, pad = counts.tolist()
    if ctx.trace:
        n_steps = min(n_steps, trace.TRACE_CALLS)

    res = {"attempted": 0, "failed": 0, "e2e": {}, "rec": None}
    t0 = time.perf_counter()
    res["setup_s"] = t0 - ctx.t_start
    if traced:
        mark = {}
        rec = _traced(call, pad, n_steps,
                      on_start=lambda: mark.update(k=state["k"]))
        p_tt = cfg["tables"][0]["tt_p_shapes"]
        stats = [[roofline.lookup_stats(ids[f][b], p_tt, bsz)
                  for f in dcfg.tt_features] for b in range(n_pool)]
        rec.update(kind="train", nnz=nnz, table_stats=[
            stats[(mark["k"] + i) % n_pool] for i in range(rec["calls"])])
        res["rec"], res["attempted"] = rec, rec["calls"]
    elif ctx.trace:
        for _ in range(2 * pad + n_steps):
            call()
    else:
        ends = res["ends"] = []
        for _ in range(n_steps):
            call()
            ends.append(time.perf_counter() - t0)
        _sync(dev)
        secs = time.perf_counter() - t0
        res["attempted"] = n_steps
        res["e2e"]["train_us_per_lookup"] = secs * 1e6 / (
            n_steps * world * nnz)
    _sync(dev)

    # the world's part of the check: every rank's first logits, the
    # replicas' gap after the window, the largest rank's peak memory
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    gathered = [torch.empty_like(logits1) for _ in range(world)]
    dist.all_gather(gathered, logits1)
    p = state.pop("params")
    gap = _replica_gap(dc.trainable_leaves(p) + list(p.optimizer_state),
                       dev)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    if not lead:
        return None
    res["memory_peak_bytes"] = int(peak.item())
    res["prog"] = (torch.cat(gathered), prog_w1, model0, ref_batch)
    res["replica_gap"] = gap.item()
    res["cards"] = cards
    return res


def run(ctx) -> dict:
    from fbtt_embedding_tpu_torch.models import dcnv2 as dc

    if ctx.control:
        return _control(ctx)
    if "group" not in inspect.signature(dc.make_dcnv2_train_step).parameters:
        raise RuntimeError("this program's make_dcnv2_train_step takes no "
                           "process group: no data-parallel step to run")
    world = ctx.mix["ranks"]
    # a file rendezvous: a port picked free and then bound can be taken
    # in between
    tmp = tempfile.mkdtemp(prefix="dlrm_train_dp_")
    url = "file://" + os.path.join(tmp, "rendezvous")
    children = [_spawn(ctx, r, world, url) for r in range(1, world)]
    done = threading.Event()
    threading.Thread(target=_watch, args=(children, done),
                     daemon=True).start()
    try:
        res = _rank(ctx, 0, world, url)
        for r, p in enumerate(children, 1):
            if p.wait(timeout=TIMEOUT_S) != 0:
                raise RuntimeError(f"rank {r} exited with code "
                                   f"{p.returncode}")
    finally:
        done.set()
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    t_check = time.perf_counter()
    prog_logits, prog_w1, model0, ref_batch = res.pop("prog")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    res["values"] = dict(_values(
        prog_logits, prog_w1, model0, ref_batch, ctx,
        base.reference_spec(ctx.config, ctx.mix)),
        replica_gap=res.pop("replica_gap"))
    res["check_s"] = time.perf_counter() - t_check
    cards = res.pop("cards")
    if cards is not None:
        _report_cards(len(cards))
    return res


def _child(arg: str) -> None:
    a = json.loads(arg)
    # a rank whose rank 0 is gone ends: its stdin, rank 0's pipe, closes
    threading.Thread(target=lambda: (sys.stdin.read(), os._exit(1)),
                     daemon=True).start()
    torch.set_num_threads(2)
    ctx = SimpleNamespace(
        config=a["config"], mix=a["mix"], seed=a["seed"],
        seconds=a["seconds"], trace=a["trace"],
        device=torch.device(a["device"]), t_start=time.perf_counter(),
        control=False, fault=a["fault"])
    _rank(ctx, a["rank"], a["world"], a["url"])


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] != "--child":
        sys.exit("usage: dlrm_train_dp.py --child <json>: a rank of a "
                 "world that rank 0 (the harness) starts")
    _child(sys.argv[2])
