"""The benchmark's weights: made from the seed, on the device, in the port's layout.

The harness makes the weights itself and hands the same values to the
program and to the plain reference, which makes them again from the same
seed: nothing the reference reads was made by the program.  The tree is the
one ``repro_torch.models.transformer.init_model`` builds (dicts, every layer
leaf stacked on a leading ``n_layers`` axis), so the program takes it as its
own.  Each leaf is one draw from one ``torch.Generator`` on the device, in
the leaf order of ``leaf_specs`` (sorted keys, as the program flattens a
tree), directly in the leaf's dtype: matrices fan-in normal, embeddings
0.02-normal, norm scales and the hybrid fusion scales 0, and mamba's
``A_log``, ``D``, ``conv_b`` and ``dt_b`` the constants the port starts from.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

F32 = torch.float32


def _model_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def leaf_specs(cfg) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], torch.dtype, str, float]]:
    """``(path, shape, dtype, init, scale)`` of every leaf, in flatten order.
    ``init`` is ``normal`` (times ``scale``), ``zeros``, ``const`` (``scale``)
    or ``alog`` (``log(1..n)`` along the last axis)."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    wdt = _model_dtype(cfg)
    layer: Dict[Tuple[str, ...], tuple] = {}

    def dense(path, fan_in, shape, scale=1.0):
        layer[path] = ((L, *shape), wdt, "normal", scale / math.sqrt(fan_in))

    layer[("norm1", "scale")] = ((L, d), F32, "zeros", 0.0)
    layer[("norm2", "scale")] = ((L, d), F32, "zeros", 0.0)
    arch = cfg["arch_type"]
    if arch != "ssm":
        h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        dense(("attn", "wq"), d, (d, h * hd))
        dense(("attn", "wk"), d, (d, kv * hd))
        dense(("attn", "wv"), d, (d, kv * hd))
        dense(("attn", "wo"), h * hd, (h * hd, d))
    if arch in ("ssm", "hybrid"):
        di, n, K = cfg["ssm_expand"] * d, cfg["ssm_state"], cfg["ssm_conv"]
        dtr = cfg["dt_rank"] or max(1, d // 16)
        dense(("mamba", "in_proj"), d, (d, 2 * di))
        dense(("mamba", "conv_w"), K, (K, di))
        layer[("mamba", "conv_b")] = ((L, di), F32, "zeros", 0.0)
        dense(("mamba", "x_proj"), di, (di, dtr + 2 * n))
        dense(("mamba", "dt_w"), dtr, (dtr, di))
        layer[("mamba", "dt_b")] = ((L, di), F32, "const", -4.6)
        layer[("mamba", "A_log")] = ((L, di, n), F32, "alog", 0.0)
        layer[("mamba", "D")] = ((L, di), F32, "const", 1.0)
        dense(("mamba", "out_proj"), di, (di, d))
    if arch == "hybrid":
        layer[("attn_out_scale",)] = ((L, d), F32, "zeros", 0.0)
        layer[("mamba_out_scale",)] = ((L, d), F32, "zeros", 0.0)
    if cfg["n_experts"]:
        raise NotImplementedError("the weights maker has no expert layers yet")
    if cfg["d_ff"]:
        f = cfg["d_ff"]
        if cfg["activation"] in ("swiglu", "geglu"):
            dense(("mlp", "wg"), d, (d, f))
        dense(("mlp", "wu"), d, (d, f))
        dense(("mlp", "wd"), f, (f, d))
    top: Dict[Tuple[str, ...], tuple] = {("embed",): ((V, d), wdt, "normal", 0.02),
                                         ("final_norm", "scale"): ((d,), F32, "zeros", 0.0)}
    if not cfg["tie_embeddings"]:
        top[("head",)] = ((d, V), wdt, "normal", 0.02)
    for path, spec in layer.items():
        top[("layers",) + path] = spec
    return [(path, *top[path]) for path in sorted(top)]


def make(cfg, seed: int, device, dtypes=None) -> Dict:
    """The weights of ``cfg`` (a dict of the configuration's numbers) from
    ``seed``, on ``device``; ``dtypes`` maps a leaf's dtype to another (the
    reference keeps the served dtype and widens per layer)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    tree: Dict = {}
    for path, shape, dtype, init, scale in leaf_specs(cfg):
        if init == "normal":
            x = torch.randn(shape, dtype=dtype, device=device, generator=gen).mul_(scale)
        elif init == "zeros":
            x = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "const":
            x = torch.full(shape, scale, dtype=dtype, device=device)
        else:
            n = shape[-1]
            x = torch.log(torch.arange(1, n + 1, dtype=F32, device=device)).expand(shape)
            x = x.to(dtype).contiguous()
        if dtypes is not None:
            x = x.to(dtypes.get(dtype, dtype))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def n_params(cfg) -> int:
    return sum(math.prod(shape) for _, shape, _, _, _ in leaf_specs(cfg))
