"""Operations of a DLRM-DCNv2 training step, from its configuration and
its traffic mix alone (the configuration's ``tables``, its TT group, all
of one TT shape; ``plain_tables``; ``features``, the order of the mix's
``multi_hot``; the tower's widths).

A step's model FLOPs are the TT chain's (``roofline.tt_flops``: the
reference's FLOP model, x3 for the forward and the backward's two passes)
over the TT group's lookups, plus the dense tower's: 2 operations a
multiply-add, x3 for the forward and the backward's two products, every
sample; the pools, the cross network's element-wise terms and the
optimizers are left out.
"""

from __future__ import annotations

from h100_bench import roofline


def tt_lookups(cfg: dict, mix: dict) -> int:
    """Lookups a sample makes into the TT group."""
    tt = {t["name"] for t in cfg["tables"]}
    return sum(n for f, n in zip(cfg["features"], mix["multi_hot"])
               if f in tt)


def lookups(mix: dict) -> int:
    """Lookups a sample makes into every table."""
    return sum(mix["multi_hot"])


def tower_macs(cfg: dict) -> int:
    """Multiply-adds of the dense tower a sample: the bottom MLP, the cross
    network's two low-rank products a layer over the interaction width
    ``(features + 1) * D``, the top MLP."""
    n = (len(cfg["features"]) + 1) * cfg["embedding_dim"]

    def mlp(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:]))

    return (mlp([cfg["dense_dim"]] + cfg["bottom_mlp_dims"])
            + cfg["dcn_num_layers"] * 2 * n * cfg["dcn_low_rank_dim"]
            + mlp([n] + cfg["top_mlp_dims"]))


def step_flops(cfg: dict, mix: dict) -> float:
    """Model FLOPs of one training step of ``mix["batch_size"]`` samples."""
    t = cfg["tables"][0]
    r = [1] + list(t["tt_ranks"]) + [1]
    b = mix["batch_size"]
    return (roofline.tt_flops(t["tt_q_shapes"], r, b * tt_lookups(cfg, mix),
                              3.0)
            + 6.0 * tower_macs(cfg) * b)
