"""Multi-process smoke worker: one rank of a ``torch.distributed`` world.

The counterpart of the JAX package's ``scripts/multihost_smoke.py``. Each
rank initialises the world (``initialize_distributed``), builds a hybrid
``(dp, mp)`` mesh, runs the table-sharded all_to_all lookup and the
data-parallel fused train step, checks every result against the same
computation on this rank alone (and the table-owned step, each rank owning
its tables' cores and Adagrad state), and prints ``MULTIHOST_OK``. It imports
neither JAX nor the JAX package.

Two processes on the CPU (gloo)::

    python -m fbtt_embedding_tpu_torch.examples.multihost_smoke \\
        --coordinator file:///tmp/fbtt_world --num-processes 2 \\
        --process-id 0 --device cpu &
    python -m fbtt_embedding_tpu_torch.examples.multihost_smoke \\
        --coordinator file:///tmp/fbtt_world --num-processes 2 \\
        --process-id 1 --device cpu

On GPUs, one process per card (``torchrun --nproc-per-node N -m ...``, no
``--coordinator``); NCCL by default on the card, ``--backend gloo`` for a
world of several ranks on one card.

``--inputs cases.npz --outputs DIR``: after the smoke, every rank runs the
cases of ``cases.npz`` (the JSON list under ``__spec__``; each case's
arrays under ``<name>/<field>``) and writes its results to
``DIR/rank<r>.npz`` (``<name>/<field>``), so that a world can be held
against another implementation (``tests/test_torch_port_parallel.py``
holds it against the JAX package). Every array is this rank's block, as
the multi-GPU entry points take and return them. Case kinds: ``dp_lookup``,
``table_lookup`` (with ``target``: the cores' gradients of a squared
error), ``dp_step`` (the data-parallel fused step; ``csr: "adapter"``
feeds each rank's CSR block through ``csr_step_adapter``), ``dlrm`` (the
table-sharded DLRM step), ``walkthrough`` (``examples.train_dlrm --tiny
--mesh``), ``replicas`` (``assert_replicas_agree`` on
agreeing and drifting values), ``mesh`` (default and one-axis meshes,
``host_local_to_global``, the hybrid mesh's and the specs' refusals),
``shard_error`` (a table count the table axis does not
divide), ``dp_cached_lookup`` (the replicated cache), ``dp_serve`` (the
data-parallel serve, folded, int8 or not folded, wide key rows too),
``table_step`` (the table-owned step; ``cache_error``: one with a cache),
``row_owned_lookup``, ``row_owned_populate``, ``row_owned_step`` (the
row-owned cache: populate, then the step) and ``value_errors`` (the
refusals of the new entries).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace
from typing import Dict

import numpy as np


def _smoke(fbt, mesh, dp: int, mp: int, device) -> None:
    """Table-sharded lookup and data-parallel fused step on ``mesh``, each
    rank's block held against the whole computation on this rank."""
    import torch

    from fbtt_embedding_tpu_torch.parallel import sharded
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice
    from fbtt_embedding_tpu_torch.utils.init import init_tt_cores

    p, q, r = [8, 8, 8], [4, 2, 2], [1, 8, 8, 1]
    e, d = 512, 16
    t, b, L = mp, 2 * dp * mp, 4
    rng = np.random.default_rng(0)  # the same on every rank
    cores_np = init_tt_cores(rng, "uniform", t, e, d, p, q, r)
    idx_np = rng.integers(0, e, size=(t, b, L)).astype(np.int32)
    full = [torch.tensor(c, device=device) for c in cores_np]

    lookup = sharded.make_table_sharded_lookup(mesh, p, q, r)
    cores = sharded.shard_params_for_table_parallel(mesh, cores_np,
                                                    device=device)
    idx = torch.tensor(host_local_slice(mesh, ("mp", "dp"), idx_np),
                       device=device)
    out = lookup(cores, idx)
    ref = sharded.fixed_pool_lookup(full, torch.tensor(idx_np, device=device),
                                    p, q, r)
    want = host_local_slice(mesh, (None, ("dp", "mp")), ref)
    _hold(out, want, "table-sharded lookup", device)

    idx1 = rng.integers(0, e, size=(1, b, L)).astype(np.int32)
    dout = (rng.normal(size=(1, b, d)) * 0.1).astype(np.float32)
    lr_eps = (0.05, 1e-10)

    def params():
        return fbt.TTEmbeddingParams(
            tuple(c[:1].clone() for c in full),
            tuple(torch.zeros(0, device=device) for _ in full))

    step = fbt.make_sharded_fused_train_step(mesh, p, q, r, 1, b, L,
                                             device=device)
    spec = (None, "dp")
    _, new = step(params(), host_local_slice(mesh, spec, idx1),
                  host_local_slice(mesh, spec, dout), lr_eps)
    ref_step = fbt.make_fused_train_step(p, q, r, 1, b, device=device)
    _, ref_new = ref_step(params(), idx1.reshape(-1),
                          np.arange(0, b * L + 1, L), dout, lr_eps)
    for a, w, o in zip(new.tt_cores, ref_new.tt_cores, params().tt_cores):
        _hold(a - o, w - o, "data-parallel step's update", device)

    # the table-owned step: each mp rank owns T / mp tables' cores and
    # their Adagrad state, the pooled embeddings go through the exchange
    dout_mp = (rng.normal(size=(t, b, d)) * 0.1).astype(np.float32)
    adagrad = (0.05, 1.0)  # eps 1: no sign-like steps on near-zero grads

    def owned_params():
        return fbt.TTEmbeddingParams(tuple(c.clone() for c in full),
                                     tuple(torch.zeros_like(c) for c in full))

    mp_step = fbt.make_table_sharded_fused_train_step(
        mesh, p, q, r, t, b, L, optimizer=fbt.OptimType.EXACT_ADAGRAD,
        device=device)
    _, mp_new = mp_step(
        fbt.shard_table_sharded_params(mesh, owned_params(), device=device),
        idx, host_local_slice(mesh, (None, ("dp", "mp")), dout_mp), adagrad)
    ref_mp = fbt.make_fused_train_step(
        p, q, r, t, b, optimizer=fbt.OptimType.EXACT_ADAGRAD, device=device)
    _, ref_new = ref_mp(owned_params(), idx_np.reshape(-1),
                        np.arange(0, t * b * L + 1, L), dout_mp, adagrad)
    want = fbt.shard_table_sharded_params(mesh, ref_new, device=device)
    old = fbt.shard_table_sharded_params(mesh, owned_params(), device=device)
    for a, w, o in zip(mp_new.tt_cores, want.tt_cores, old.tt_cores):
        _hold(a - o, w - o, "table-owned step's update", device)


def _hold(got, want, what: str, device) -> None:
    """``got`` against ``want``: rtol 1e-5 on the CPU (float32 plain
    versions); on the card, where the lookups stage in bfloat16 and the
    ranks' batches differ from the whole one, within 3e-2 of max|want|."""
    import torch

    if device.type == "cpu":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if not err <= 3e-2 * scale:
        raise AssertionError(f"{what}: max error {err:.3e} against "
                             f"max|want| {scale:.3e}")


class _Cases:
    """The arrays of a cases file and the results of this rank."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            self.arrays = {k: z[k] for k in z.files}
        self.spec = json.loads(str(self.arrays.pop("__spec__")))
        self.out: Dict[str, np.ndarray] = {}

    def get(self, case: str, field: str):
        return self.arrays.get(f"{case}/{field}")

    def seq(self, case: str, field: str):
        """The arrays ``<field>/0``, ``<field>/1``, ... of a case."""
        out, i = [], 0
        while f"{case}/{field}/{i}" in self.arrays:
            out.append(self.arrays[f"{case}/{field}/{i}"])
            i += 1
        return out

    def put(self, case: str, field: str, value) -> None:
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        self.out[f"{case}/{field}"] = np.asarray(value)


def _run_cases(fbt, cases: _Cases, device, rank: int) -> None:
    import torch

    from fbtt_embedding_tpu_torch.models import dlrm
    from fbtt_embedding_tpu_torch.parallel import sharded
    from fbtt_embedding_tpu_torch.parallel.mesh import axis_index
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice
    from fbtt_embedding_tpu_torch.utils import guard

    meshes = {}

    def mesh_of(c):
        key = (tuple(c["mesh"]), tuple(c.get("axes", ("dp", "mp"))))
        if key not in meshes:
            meshes[key] = fbt.make_mesh(key[0], key[1],
                                        device_type=device.type)
        return meshes[key]

    def dev(a):
        return torch.tensor(a, device=device)

    for c in cases.spec:
        name, kind = c["name"], c["kind"]
        mesh = mesh_of(c)
        shapes = (c["p"], c["q"], c["r"]) if "p" in c else None
        if kind == "dp_lookup":
            lookup = sharded.make_dp_lookup(mesh, *shapes,
                                            batch_axes=tuple(c["axes"]))
            idx = host_local_slice(mesh, (None, tuple(c["axes"])),
                                   cases.get(name, "indices"))
            cores = [dev(a) for a in cases.seq(name, "cores")]
            cases.put(name, "out", lookup(cores, dev(idx)))
        elif kind == "table_lookup":
            lookup = sharded.make_table_sharded_lookup(mesh, *shapes)
            cores = [t.requires_grad_() for t in
                     sharded.shard_params_for_table_parallel(
                         mesh, cases.seq(name, "cores"), device=device)]
            idx = host_local_slice(mesh, ("mp", "dp"),
                                   cases.get(name, "indices"))
            out = lookup(cores, dev(idx))
            cases.put(name, "out", out)
            target = cases.get(name, "target")
            if target is not None:
                block = dev(host_local_slice(mesh, (None, ("dp", "mp")),
                                             target))
                loss = ((out - block) ** 2).sum() / target.size
                for i, g in enumerate(torch.autograd.grad(loss, cores)):
                    cases.put(name, f"grad/{i}", g)
        elif kind == "dp_step":
            _dp_step_case(fbt, cases, c, mesh, device)
        elif kind == "dlrm":
            cfg = dlrm.DLRMConfig(**c["cfg"])
            mlps = {pre: SimpleNamespace(weights=cases.seq(name, pre + "_w"),
                                         biases=cases.seq(name, pre + "_b"))
                    for pre in ("bottom", "top")}
            params = dlrm.dlrm_params_from_jax(
                SimpleNamespace(tt_cores=cases.seq(name, "cores"),
                                bottom_mlp=mlps["bottom"],
                                top_mlp=mlps["top"]),
                device=device, mesh=mesh)
            step = dlrm.make_dlrm_train_step(cfg, mesh=mesh,
                                             learning_rate=c["lr"],
                                             device=device)
            batch = (host_local_slice(mesh, (("dp", "mp"),),
                                      cases.get(name, "dense")),
                     host_local_slice(mesh, ("mp", "dp"),
                                      cases.get(name, "indices")),
                     host_local_slice(mesh, (("dp", "mp"),),
                                      cases.get(name, "labels")))
            losses = []
            for _ in range(c["steps"]):
                loss, params = step(params, *batch)
                losses.append(float(loss))
            cases.put(name, "loss", np.asarray(losses))
            for i, core in enumerate(params.tt_cores):
                cases.put(name, f"core/{i}", core)
            for i, w in enumerate(params.top_mlp.weights):
                cases.put(name, f"top_w/{i}", w)
        elif kind == "replicas":
            guard.assert_replicas_agree(mesh, "dp", dev(np.float32(3.0)))
            guard.assert_replicas_agree(mesh, "mp", dev(np.arange(5.0)))
            cases.put(name, "agree_ok", 1)
            mine = dev(np.float32(axis_index(mesh, "dp")))
            try:
                guard.assert_replicas_agree(mesh, "dp", mine,
                                            what="step_count")
                cases.put(name, "diverge_raised", 0)
            except guard.ReplicaDivergenceError:
                cases.put(name, "diverge_raised", 1)
        elif kind == "walkthrough":
            from fbtt_embedding_tpu_torch.examples import train_dlrm

            res = train_dlrm.main(
                ["--tiny", "--steps", str(c["steps"]), "--mesh",
                 ",".join(str(v) for v in c["mesh"]), "--device",
                 device.type, "--ckpt-dir", cases.ckpt_dir])
            cases.put(name, "losses", np.asarray(res["losses"]))
            cases.put(name, "auc", res["auc"])
            cases.put(name, "ckpt_exists", int(os.path.exists(res["ckpt"])))
        elif kind == "mesh":
            default = fbt.make_mesh(device_type=device.type)
            cases.put(name, "default_shape", list(default.mesh.shape))
            cases.put(name, "default_names", np.asarray(
                default.mesh_dim_names))
            one = fbt.make_mesh((mesh.size(),), ("mp",),
                                device_type=device.type)
            cases.put(name, "one_axis_names", np.asarray(one.mesh_dim_names))
            block = fbt.parallel.host_local_to_global(
                mesh, (("dp", "mp"),), {"x": np.zeros((3, 2), np.float32)},
                device=device)["x"]
            cases.put(name, "block_shape", list(block.shape))
            raised = []
            for bad in (lambda: fbt.make_hybrid_mesh(dp=mesh.size(), mp=2),
                        lambda: fbt.parallel.host_local_to_global(
                            mesh, ("dp", "dp"), np.zeros((2, 2)), device),
                        lambda: fbt.parallel.host_local_slice(
                            mesh, ("dp",), np.zeros(3))):
                try:
                    bad()
                    raised.append(0)
                except ValueError:
                    raised.append(1)
            cases.put(name, "raised", raised)
        elif kind in _NEW_KINDS:
            _NEW_KINDS[kind](fbt, cases, c, mesh, device)
        elif kind == "shard_error":
            try:
                sharded.shard_params_for_table_parallel(
                    mesh, [np.zeros((c["T"], 2, 2), np.float32)],
                    device=device)
                cases.put(name, "raised", 0)
            except ValueError:
                cases.put(name, "raised", 1)
        else:
            raise ValueError(f"unknown case kind {kind!r}")
    cases.put("__worker__", "rank", rank)
    cases.put("__worker__", "jax_imported",
              int(any(m == "jax" or m.startswith("jax.")
                      or m == "fbtt_embedding_tpu"
                      or m.startswith("fbtt_embedding_tpu.")
                      for m in sys.modules)))


def _dp_step_case(fbt, cases: _Cases, c, mesh, device) -> None:
    """One ``dp_step`` case: for each entry of ``calls``, the step from
    fresh copies of the case's params; results under ``<k>/...``."""
    from fbtt_embedding_tpu_torch.parallel import sharded
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

    name = c["name"]
    t, b, length = c["T"], c["B"], c["L"]
    optim = fbt.OptimType[c["optimizer"]]
    step = fbt.make_sharded_fused_train_step(
        mesh, c["p"], c["q"], c["r"], t, b, length, optimizer=optim,
        use_cache=c.get("use_cache", False),
        probe_cache=c.get("probe_cache", False),
        count_interval=c.get("count_interval", 1),
        optim_semantics=c.get("optim_semantics", "reference"),
        impl=c.get("impl", "auto"), device=device)
    cores = cases.seq(name, "cores")
    opt = cases.seq(name, "opt")
    cache = cases.seq(name, "cache")

    def params():
        return fbt.params_from_jax(
            cores, opt, device=device,
            cache=(dict(zip(("keys", "freq", "slots", "weight",
                             "opt_state"), cache)) if cache else None))

    spec = (None, "dp")
    d_out = host_local_slice(mesh, spec, cases.get(name, "d_out"))
    lr_eps = (float(cases.get(name, "lr")), float(cases.get(name, "eps")))
    weights = cases.get(name, "weights")
    if c.get("csr") == "adapter":
        bl = b // mesh.size()
        r = mesh.get_local_rank("dp")
        idx, offs = cases.get(name, "csr_indices"), cases.get(name,
                                                             "csr_offsets")
        lo, hi = int(offs[r * bl]), int(offs[(r + 1) * bl])
        if t != 1:
            raise ValueError("the adapter case takes one table")
        run = sharded.csr_step_adapter(step, t, bl, length)
        args = (idx[lo:hi], offs[r * bl:(r + 1) * bl + 1] - lo, d_out,
                lr_eps)
        if weights is not None:
            weights = weights[lo:hi]
    else:
        run = step
        args = (host_local_slice(mesh, spec, cases.get(name, "indices")),
                d_out, lr_eps)
        if weights is not None:
            weights = host_local_slice(mesh, spec, weights)
    for k, call in enumerate(c.get("calls", [{}])):
        out, new = run(params(), *args, weights=weights,
                       count=call.get("count", True))
        cases.put(name, f"{k}/out", out)
        for i, x in enumerate(new.tt_cores):
            cases.put(name, f"{k}/core/{i}", x)
        for i, x in enumerate(new.optimizer_state):
            cases.put(name, f"{k}/opt/{i}", x)
        if new.cache is not None:
            for f in ("keys", "freq", "slots", "weight", "opt_state"):
                cases.put(name, f"{k}/cache/{f}", getattr(new.cache, f))


def _cache_of(cases: _Cases, name: str, device, field: str = "cache"):
    """The case's cache (its five fields under ``<field>/0..4``) as a
    ``CacheState`` on ``device``, or None."""
    import torch

    from fbtt_embedding_tpu_torch.ops.cache import CacheState

    fields = cases.seq(name, field)
    if not fields:
        return None
    return CacheState(*(torch.tensor(a, device=device) for a in fields))


def _put_cache(cases: _Cases, name: str, prefix: str, cache) -> None:
    for f in ("keys", "freq", "slots", "weight", "opt_state"):
        cases.put(name, f"{prefix}/{f}", getattr(cache, f))


def _dp_cached_lookup_case(fbt, cases, c, mesh, device) -> None:
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

    import torch

    name = c["name"]
    lookup = fbt.make_dp_cached_lookup(mesh, c["p"], c["q"], c["r"],
                                       device=device)
    idx = host_local_slice(mesh, (None, "dp"), cases.get(name, "indices"))
    cores = [torch.tensor(a, device=device) for a in cases.seq(name,
                                                               "cores")]
    cases.put(name, "out", lookup(cores, _cache_of(cases, name, device),
                                  idx))


def _dp_serve_case(fbt, cases, c, mesh, device) -> None:
    """``calls``: each ``{"weights": bool}`` serves the case's indices with
    or without its weights; results ``<k>/out``."""
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

    name = c["name"]
    params = fbt.params_from_jax(cases.seq(name, "cores"), device=device)
    params.cache = _cache_of(cases, name, device)
    fold, serve = fbt.make_dp_serving_fn(
        mesh, c["p"], c["q"], c["r"], c["T"], c["B"], c["L"],
        probe_cache=True, folded=c["folded"], quantize=c.get("quantize"),
        device=device)
    fp = fold(params)
    cases.put(name, "flat_mode", int(fp.setup is not None))
    cases.put(name, "cache_int8", int(
        fp.cache is not None and str(fp.cache.weight.dtype) == "torch.int8"))
    idx = cases.get(name, "indices")
    idx = host_local_slice(mesh, (None, "dp") + (None,) * (idx.ndim - 2),
                           idx)
    w = cases.get(name, "weights")
    for k, call in enumerate(c["calls"]):
        use_w = call["weights"]
        cases.put(name, f"{k}/out", serve(
            fp, idx, host_local_slice(mesh, (None, "dp"), w) if use_w
            else None))


def _table_step_case(fbt, cases, c, mesh, device) -> None:
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

    name = c["name"]
    step = fbt.make_table_sharded_fused_train_step(
        mesh, c["p"], c["q"], c["r"], c["T"], c["B"], c["L"],
        optimizer=fbt.OptimType[c["optimizer"]],
        optim_semantics=c.get("optim_semantics", "reference"), device=device)
    params = fbt.shard_table_sharded_params(
        mesh, fbt.TTEmbeddingParams(cases.seq(name, "cores"),
                                    cases.seq(name, "opt")), device=device)
    idx = host_local_slice(mesh, ("mp", "dp"), cases.get(name, "indices"))
    d_out = host_local_slice(mesh, (None, ("dp", "mp")),
                             cases.get(name, "d_out"))
    w = cases.get(name, "weights")
    lr_eps = (float(cases.get(name, "lr")), float(cases.get(name, "eps")))
    if c.get("cache_error"):
        params.cache = _cache_of(cases, name, device)
        try:
            step(params, idx, d_out, lr_eps)
            cases.put(name, "raised", "")
        except ValueError as e:
            cases.put(name, "raised", str(e))
        return
    out, new = step(params, idx, d_out, lr_eps,
                    weights=None if w is None
                    else host_local_slice(mesh, ("mp", "dp"), w))
    cases.put(name, "out", out)
    for i, x in enumerate(new.tt_cores):
        cases.put(name, f"core/{i}", x)
    for i, x in enumerate(new.optimizer_state):
        cases.put(name, f"opt/{i}", x)


def _row_owned_lookup_case(fbt, cases, c, mesh, device) -> None:
    import torch

    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

    name = c["name"]
    cache = _cache_of(cases, name, device)
    w_owned = fbt.shard_cache_weight_by_owner(mesh, cases.seq(name,
                                                              "cache")[3],
                                              device=device)
    cases.put(name, "w_owned", w_owned)
    lookup = fbt.make_row_owned_cached_lookup(
        mesh, c["p"], c["q"], c["r"], c["C"], device=device)
    cores = [torch.tensor(a, device=device) for a in cases.seq(name,
                                                               "cores")]
    idx = host_local_slice(mesh, (None, "dp"), cases.get(name, "indices"))
    cases.put(name, "out", lookup(cores, cache.slots, w_owned, idx))


def _row_owned_populate_case(fbt, cases, c, mesh, device) -> None:
    name = c["name"]
    populate = fbt.make_row_owned_populate(
        mesh, c["p"], c["q"], c["r"], c["C"], opt_state_kind=c["opt_kind"],
        device=device)
    cores = fbt.params_from_jax(cases.seq(name, "cores"),
                                device=device).tt_cores
    new_cache, w_owned, opt_owned = populate(
        _cache_of(cases, name, device), cores)
    _put_cache(cases, name, "cache", new_cache)
    cases.put(name, "w_owned", w_owned)
    cases.put(name, "opt_owned", opt_owned)


def _row_owned_step_case(fbt, cases, c, mesh, device) -> None:
    """The owned lifecycle: populate on the owners, then one step."""
    from fbtt_embedding_tpu_torch.parallel.multihost import host_local_slice

    name = c["name"]
    params = fbt.params_from_jax(cases.seq(name, "cores"),
                                 cases.seq(name, "opt"), device=device)
    populate = fbt.make_row_owned_populate(
        mesh, c["p"], c["q"], c["r"], c["C"], opt_state_kind=c["opt_kind"],
        device=device)
    params.cache, w_owned, opt_owned = populate(
        _cache_of(cases, name, device), params.tt_cores)
    step = fbt.make_row_owned_fused_train_step(
        mesh, c["p"], c["q"], c["r"], c["C"], c["B"], c["L"],
        optimizer=fbt.OptimType[c["optimizer"]], device=device)
    spec = (None, "dp")
    lr_eps = (float(cases.get(name, "lr")), float(cases.get(name, "eps")))
    out, new, w2, o2 = step(
        params, w_owned, opt_owned,
        host_local_slice(mesh, spec, cases.get(name, "indices")),
        host_local_slice(mesh, spec, cases.get(name, "d_out")), lr_eps,
        weights=host_local_slice(mesh, spec, cases.get(name, "weights")))
    cases.put(name, "out", out)
    for i, x in enumerate(new.tt_cores):
        cases.put(name, f"core/{i}", x)
    cases.put(name, "freq", new.cache.freq)
    cases.put(name, "w_owned", w2)
    cases.put(name, "opt_owned", o2)


def _value_errors_case(fbt, cases, c, mesh, device) -> None:
    """Whether each refusal raised ValueError, on a ``(1, n)`` mesh: an
    ``mp`` that does not divide T; a cache_size that the ranks (``mp``
    taken as the batch axis) do not divide, in the row-owned lookup,
    populate and step; a row-owned step given two tables."""
    import numpy as _np

    name = c["name"]
    p, q, r = c["p"], c["q"], c["r"]
    n = mesh.size()
    own = dict(batch_axis="mp", device=device)
    step = fbt.make_row_owned_fused_train_step(mesh, p, q, r, 2 * n, 2 * n,
                                               2, **own)
    params = fbt.params_from_jax(
        [_np.zeros((1, pi, r[i] * q[i] * r[i + 1]), _np.float32)
         for i, pi in enumerate(p)], device=device)
    attempts = [
        lambda: fbt.make_table_sharded_fused_train_step(
            mesh, p, q, r, n + 1, 4 * n, 2, device=device),
        lambda: fbt.make_row_owned_cached_lookup(mesh, p, q, r, n + 1, **own),
        lambda: fbt.make_row_owned_populate(mesh, p, q, r, n + 1, **own),
        lambda: fbt.make_row_owned_fused_train_step(mesh, p, q, r, n + 1,
                                                    2 * n, 2, **own),
        lambda: step(params, _np.zeros((2, 1), _np.float32),
                     _np.zeros(0, _np.float32), _np.zeros((2, 2, 2),
                                                          _np.int32),
                     _np.zeros((2, 2, int(_np.prod(q))), _np.float32),
                     (0.1, 1.0)),
    ]
    raised = []
    for attempt in attempts:
        try:
            attempt()
            raised.append(0)
        except ValueError:
            raised.append(1)
    cases.put(name, "raised", raised)


_NEW_KINDS = {
    "dp_cached_lookup": _dp_cached_lookup_case,
    "dp_serve": _dp_serve_case,
    "table_step": _table_step_case,
    "row_owned_lookup": _row_owned_lookup_case,
    "row_owned_populate": _row_owned_populate_case,
    "row_owned_step": _row_owned_step_case,
    "value_errors": _value_errors_case,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port or init URL (default: torchrun's "
                         "variables or FBTT_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mp", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="nccl on the card, gloo on the CPU by default")
    ap.add_argument("--inputs", default=None, help="cases npz to run")
    ap.add_argument("--outputs", default=None,
                    help="directory for rank<r>.npz results")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for the others")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    import fbtt_embedding_tpu_torch as fbt

    torch.set_num_threads(1)  # several ranks share the host's cores
    ok = fbt.initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id, backend=args.backend,
                                    device=args.device,
                                    timeout_s=args.timeout)
    if not ok:
        raise SystemExit("multihost_smoke: no world to join (give "
                         "--coordinator/--num-processes/--process-id or "
                         "launch with torchrun)")
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mp = args.mp if world % args.mp == 0 else 1
        mesh = fbt.make_hybrid_mesh(mp=mp, device_type=device.type)
        _smoke(fbt, mesh, world // mp, mp, device)
        print(f"MULTIHOST_OK process={rank} global={world} "
              f"mesh=({world // mp}x{mp}) backend={dist.get_backend()}",
              flush=True)
        if args.inputs:
            cases = _Cases(args.inputs)
            os.makedirs(args.outputs, exist_ok=True)
            cases.ckpt_dir = os.path.join(args.outputs, "ckpt")
            _run_cases(fbt, cases, device, rank)
            np.savez(os.path.join(args.outputs, f"rank{rank}.npz"),
                     **cases.out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
