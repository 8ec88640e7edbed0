"""Driver of the traffic kind ``dlrm_train``: a DLRM-DCNv2 training step.

The configuration gives the TT group (``tables``, one TT shape),
``plain_tables``, the order of the ``features`` and the tower's widths;
the mix the batch, each feature's multi-hot size (``multi_hot``), the id
law, the pool and the optimizer.

Set-up makes from the seed the weights (TT-Rec's uniform cores, one
stream per table; the plain tables uniform on +-sqrt(1/rows); the MLPs as
``nn.Linear``; the cross network Xavier-normal, zero bias) and a pool of
``pool_batches`` batches: each table's ids Zipf(``alpha``) by
``inputs.generate_requests`` on a stream of its own, folded into its rows
and scattered by ``rank * hash_multiplier mod rows`` (a bijection), dense
features N(0, 1), labels Bernoulli(``label_rate``). It builds the
program's step (``models/dcnv2.py::make_dcnv2_train_step``) and drives it
through its first steps on batches 0, 1, 2, .. of the pool, keeping the
first step's logits, the optimizer's state after it and the weights after
it. The window then issues the same step back to back on the next
batches of the pool, with no synchronisation until its end.

``correct`` compares the first step against the plain float32 reference
(``reference/dlrm_dcnv2_plain.py``) on the same weights and batch, part
by part of the model (``parts``: each TT table, each plain table, the
bottom MLP, the cross network, the top MLP): the logits (``logit_err``:
max|out - ref| over the reference logits' standard deviation across the
batch, see ``logit_err``), the gradient as Adagrad's state holds it
(``grad_gap``: the worst part's gap of norms of sqrt(state), which is |g|,
row-wise its root mean square on the plain tables) and the weights'
change (``change_gap``: the worst part's gap of norms of w1 - w0). One
step and not more: with labels independent of the features, Adagrad's
first steps move every weight by about +-lr, and whether the steps after
the first agree in sign turns on how the batch's residuals
sigmoid(z) - y cancel, so a second and third step's change differs
between float32 and the program's bfloat16 by up to a third, and no less
in the control (PERF.md section 4).

``ctx.control``: the reference, staged in the precision below the
configuration's (``control_stage``), takes the program's place in the
first step and no window runs. ``ctx.fault``: the step broken on purpose
for the tests: ``"frozen"`` (the state is left unchanged),
``"half_batch"`` (the second half of each TT table's bags left empty, by
weights of 0) or ``"tables_swapped"`` (the last two TT tables served by
each other's cores).
"""

from __future__ import annotations

import math
import time

import torch

from h100_bench import checks, inputs, roofline, spec, trace

ref = spec.load_module(spec.HERE / "reference" / "dlrm_dcnv2_plain.py",
                       "h100_bench_reference_dlrm_dcnv2_plain")

WARM_STEPS = 7    # steps of set-up after the one the reference follows
# streams of ``inputs.torch_gen`` past the ones ``inputs`` names
STREAM_WEIGHTS, STREAM_DENSE, STREAM_LABELS, STREAM_IDS = 4, 5, 6, 16


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def features(cfg):
    """``(name, rows, TT table index or None)`` per feature, in order."""
    tt = {t["name"]: k for k, t in enumerate(cfg["tables"])}
    rows = {t["name"]: t["num_embeddings"]
            for t in cfg["tables"] + cfg["plain_tables"]}
    return [(f, rows[f], tt.get(f)) for f in cfg["features"]]


def model_config(fbt_dcnv2, cfg, mix):
    """The program's ``DCNv2Config`` of the cell."""
    feats = features(cfg)
    t = cfg["tables"][0]
    for other in cfg["tables"]:
        if any(other[k] != t[k] for k in ("tt_p_shapes", "tt_q_shapes",
                                          "tt_ranks")):
            raise ValueError(f"TT table {other['name']} is not of "
                             f"{t['name']}'s TT shape: one TT group")
    return fbt_dcnv2.DCNv2Config(
        [n for _, n, _ in feats], mix["multi_hot"],
        [i for i, (_, _, k) in enumerate(feats) if k is not None],
        t["tt_p_shapes"], t["tt_q_shapes"], t["tt_ranks"],
        embedding_dim=cfg["embedding_dim"], dense_dim=cfg["dense_dim"],
        bottom_mlp_dims=cfg["bottom_mlp_dims"],
        top_mlp_dims=cfg["top_mlp_dims"],
        dcn_num_layers=cfg["dcn_num_layers"],
        dcn_low_rank_dim=cfg["dcn_low_rank_dim"])


def reference_spec(cfg, mix):
    feats = features(cfg)
    t = cfg["tables"][0]
    return {"pooling": list(mix["multi_hot"]),
            "tt_features": [i for i, (_, _, k) in enumerate(feats)
                            if k is not None],
            "p": t["tt_p_shapes"], "q": t["tt_q_shapes"],
            "ranks": [1] + list(t["tt_ranks"]) + [1]}


def make_weights(cfg, seed, dev) -> dict:
    """The initial weights from the seed, in the reference's layout."""
    cores = [inputs.make_cores(t, seed * 64 + k, dev)
             for k, t in enumerate(cfg["tables"])]
    g = inputs.torch_gen(seed, STREAM_WEIGHTS, dev)
    d = cfg["embedding_dim"]

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    def linear(dims):
        return [(uniform((a, b), 1 / math.sqrt(a)),
                 uniform((b,), 1 / math.sqrt(a)))
                for a, b in zip(dims[:-1], dims[1:])]

    n = (len(cfg["features"]) + 1) * d
    k = cfg["dcn_low_rank_dim"]
    std = math.sqrt(2.0 / (n + k))
    plain = {t["name"]: uniform((t["num_embeddings"], d),
                                math.sqrt(1.0 / t["num_embeddings"]))
             for t in cfg["plain_tables"]}
    return {
        "tt": [torch.cat([c[t] for c in cores]) for t in range(
            len(cores[0]))],
        "plain": [plain[f] for f, _, kk in features(cfg) if kk is None],
        "bottom": linear([cfg["dense_dim"]] + cfg["bottom_mlp_dims"]),
        "cross": [(torch.randn((n, k), generator=g, device=dev) * std,
                   torch.randn((k, n), generator=g, device=dev) * std,
                   torch.zeros(n, device=dev))
                  for _ in range(cfg["dcn_num_layers"])],
        "top": linear([n] + cfg["top_mlp_dims"]),
    }


def make_batches(cfg, mix, seed, n, dev):
    """``(dense [n, B, 13], labels [n, B], ids)``: ``ids`` one ``[n, B,
    L_f]`` int64 tensor per feature."""
    b = mix["batch_size"]
    ids = []
    for f, ((_, rows, _), length) in enumerate(zip(features(cfg),
                                                   mix["multi_hot"])):
        rank = inputs.generate_requests(
            inputs.torch_gen(seed, STREAM_IDS + f, dev), n, b * length, rows,
            alpha=mix["alpha"], device=dev)
        ids.append((rank * int(mix["hash_multiplier"]) % rows)
                   .reshape(n, b, length))
    dense = torch.randn((n, b, cfg["dense_dim"]), device=dev,
                        generator=inputs.torch_gen(seed, STREAM_DENSE, dev))
    labels = (torch.rand((n, b), device=dev, generator=inputs.torch_gen(
        seed, STREAM_LABELS, dev)) < mix["label_rate"]).float()
    return dense, labels, ids


def _tmap(fn, *trees):
    """``fn`` over the tensors of trees laid out as the reference's."""
    return {k: [tuple(fn(*ts) for ts in zip(*xs))
                if isinstance(xs[0], tuple) else fn(*xs)
                for xs in zip(*(t[k] for t in trees))] for k in trees[0]}


def _clone(model):
    return _tmap(torch.clone, model)


def program_params(dc, model, optimizer):
    """The program's parameters from the reference's layout (copies)."""
    def mlp(layers):
        return dc.MLPParams(tuple(w.clone() for w, _ in layers),
                            tuple(b.clone() for _, b in layers))

    params = dc.DCNv2Params(
        tuple(c.clone() for c in model["tt"]), torch.cat(model["plain"]),
        mlp(model["bottom"]),
        dc.CrossParams(*(tuple(layer[i].clone() for layer in model["cross"])
                         for i in range(3))),
        mlp(model["top"]))
    params.optimizer_state = dc.init_optimizer_state(params, optimizer)
    return params


def reference_layout(dc, params, offsets, leaves=None):
    """Copies of the program's trainable leaves (or of ``leaves``, a tuple
    laid out as them, such as the optimizer's state) in the reference's
    layout, the plain buffer cut at ``offsets`` into its tables."""
    it = iter(dc.trainable_leaves(params) if leaves is None else leaves)

    def take(n):
        return [next(it).clone() for _ in range(n)]

    nb, nc, nt = (len(params.bottom_mlp.weights), len(params.cross.v),
                  len(params.top_mlp.weights))
    tt, (plain,) = take(len(params.tt_cores)), take(1)
    bottom = list(zip(take(nb), take(nb)))
    cross = list(zip(take(nc), take(nc), take(nc)))
    top = list(zip(take(nt), take(nt)))
    return {"tt": tt, "plain": [plain[a:b] for a, b in zip(offsets[:-1],
                                                           offsets[1:])],
            "bottom": bottom, "cross": cross, "top": top}


def parts(tree) -> list:
    """A tree in the reference's layout as the parts ``correct`` holds to
    the reference one by one, each flattened: each TT table (its slice of
    the three cores), each plain table, the bottom MLP, the cross network
    and the top MLP."""
    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    out = [flat([c[k] for c in tree["tt"]])
           for k in range(tree["tt"][0].shape[0])]
    out += [t.reshape(-1) for t in tree["plain"]]
    return out + [flat([t for layer in tree[m] for t in layer])
                  for m in ("bottom", "cross", "top")]


def logit_err(out, ref) -> float:
    """max|out - ref| over the batch's spread of the reference logits (their
    standard deviation): the logits share one offset, the top MLP's bias,
    and differ by a spread of ~1e-3 at initialisation."""
    ref = ref.double()
    return (out.double() - ref).abs().max().item() / ref.std().item()


def run(ctx) -> dict:
    from fbtt_embedding_tpu_torch.models import dcnv2 as dc

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    bsz, n_pool = mix["batch_size"], mix["pool_batches"]
    lr, eps, opt = mix["learning_rate"], mix["eps"], mix["optimizer"]
    dcfg = model_config(dc, cfg, mix)
    rspec = reference_spec(cfg, mix)
    offsets = dcfg.plain_offsets
    nnz = bsz * dcfg.lookups()
    dense, labels, ids = make_batches(cfg, mix, ctx.seed, n_pool, dev)
    ref_batch = (dense[0], [x[0] for x in ids], labels[0], None)
    weights = None
    if ctx.fault == "half_batch":
        weights = tuple(torch.ones((bsz, n), device=dev)
                        for n in mix["multi_hot"])
        for f in dcfg.tt_features:
            weights[f][bsz // 2:] = 0
    model0 = make_weights(cfg, ctx.seed, dev)
    state = None
    if ctx.control:
        prog_w1 = _clone(model0)
        _, logits, prog_state1 = ref.steps(prog_w1, rspec, [ref_batch], lr,
                                           eps, opt,
                                           stage=cfg["control_stage"])
        prog_logits1 = logits[0]
    else:
        params = program_params(dc, model0, opt)
        if ctx.fault == "tables_swapped":
            for c in params.tt_cores:
                c[[-2, -1]] = c[[-1, -2]].clone()
        step = dc.make_dcnv2_train_step(dcfg, bsz, optimizer=opt,
                                        learning_rate=lr, eps=eps,
                                        device=dev, impl=cfg["impl"])
        state = {"params": params, "k": 0}

        def call():
            k = state["k"] % n_pool
            p = state["params"]
            saved = ([t.clone() for t in dc.trainable_leaves(p)
                      + list(p.optimizer_state)]
                     if ctx.fault == "frozen" else None)
            with trace.span("step", ctx.trace):
                _, logits, state["params"] = step(p, dc.DCNv2Batch(
                    dense[k], tuple(x[k] for x in ids), labels[k], weights))
            if saved is not None:
                now = dc.trainable_leaves(p) + list(p.optimizer_state)
                for t, s in zip(now, saved):
                    t.copy_(s)
            state["k"] += 1
            return logits

        prog_logits1 = call().clone()
        prog_state1 = reference_layout(dc, params, offsets,
                                       params.optimizer_state)
        prog_w1 = reference_layout(dc, params, offsets)
        for _ in range(WARM_STEPS):
            call()
        del params
    _sync(dev)

    res = {"attempted": 0, "failed": 0, "e2e": {}, "rec": None}
    t0 = time.perf_counter()
    res["setup_s"] = t0 - ctx.t_start
    if ctx.control:
        pass  # the control's readings need no window
    elif ctx.trace:
        mark = {}
        rec = trace.traced_window(call, ctx.seconds,
                                  on_start=lambda: mark.update(k=state["k"]))
        p_tt = cfg["tables"][0]["tt_p_shapes"]
        stats = [[roofline.lookup_stats(ids[f][b], p_tt, bsz)
                  for f in dcfg.tt_features] for b in range(n_pool)]
        rec.update(kind="train", nnz=nnz, table_stats=[
            stats[(mark["k"] + i) % n_pool] for i in range(rec["calls"])])
        res["rec"], res["attempted"] = rec, rec["calls"]
    else:
        ends = res["ends"] = []
        while True:
            call()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= ctx.seconds:
                break
        _sync(dev)
        secs = time.perf_counter() - t0
        n = res["attempted"] = len(ends)
        res["e2e"]["train_us_per_lookup"] = secs * 1e6 / (n * nnz)
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    t_check = time.perf_counter()

    # the check: the first step's logits, state and change against the
    # float32 reference on the same weights and batch
    if state is not None:
        del state["params"], call, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_w1 = _clone(model0)
    _, ref_logits, ref_state1 = ref.steps(ref_w1, rspec, [ref_batch], lr,
                                          eps, opt)
    res["values"] = {
        "logit_err": logit_err(prog_logits1, ref_logits[0]),
        "grad_gap": checks.norm_gap(parts(_tmap(torch.sqrt, prog_state1)),
                                    parts(_tmap(torch.sqrt, ref_state1))),
        "change_gap": checks.norm_gap(
            parts(_tmap(torch.sub, prog_w1, model0)),
            parts(_tmap(torch.sub, ref_w1, model0))),
    }
    res["check_s"] = time.perf_counter() - t_check
    return res
