"""Plain float32 reference of the decoders the benchmark runs: dense, SSM, hybrid.

Written from the architectures' published descriptions as the port lays out
their parameters (``harness.weights``): pre-norm residual blocks with RMSNorm
in the ``(1 + scale)`` form; GQA attention with rotary embeddings on the two
halves of each head, causal, windowed on the layers the configuration's
pattern makes local; the Mamba-1 mixer (in_proj to u and z, a causal
depthwise convolution, SiLU, x_proj to dt, B and C, ``dt = softplus(dt_low
dt_w + dt_b)``, the selective recurrence ``h_t = exp(dt A) h_{t-1} + dt u_t
B_t``, ``y = h C + D u``, gated by SiLU(z), out_proj); hymba's fusion of the
two branches as the mean of their RMS-normalised outputs; a SwiGLU MLP; the
embedding scaled by sqrt(d_model); the head untied or the embedding's
transpose.  The recurrence is the loop over time itself.

Every operation is float32, with TF32 off.  With ``control=True`` every
matrix product takes both operands rounded to fp8 (e4m3, one scale per
tensor, straight through under autograd): the lower precision that a
benchmark's control computes in.  Imports only torch.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one per-tensor scale, gradient straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x.detach())


class Decoder:
    """The reference forward over a parameter tree in the port's layout."""

    def __init__(self, cfg: Dict, control: bool = False):
        self.c = cfg
        self.control = control
        no_tf32()

    # ---- products and norms -------------------------------------------- #
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(F32), b.to(F32)
        if self.control:
            a, b = fp8(a), fp8(b)
        return a @ b

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control:
            a, b = fp8(a), fp8(b)
        return torch.einsum(eq, a, b)

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["norm_eps"]) * (1.0 + scale.to(F32))

    def windows(self) -> List[Optional[int]]:
        c, L = self.c, self.c["n_layers"]
        if c["arch_type"] == "ssm":
            return [None] * L
        pat, w = c["layer_pattern"], c["window"]
        if pat == "global":
            return [None] * L
        if pat == "local":
            return [w] * L
        if pat == "local_global":
            return [w if i % 2 == 0 else None for i in range(L)]
        if pat == "hymba":
            glb = {0, L // 2, L - 1}
            return [None if i in glb else w for i in range(L)]
        raise ValueError(pat)

    # ---- attention ------------------------------------------------------ #
    def rope(self, x: torch.Tensor) -> torch.Tensor:
        S, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / (self.c["rope_theta"] ** (torch.arange(0, hd, 2, dtype=F32,
                                                           device=x.device) / hd))
        ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, p: Dict, x: torch.Tensor, window: Optional[int]) -> torch.Tensor:
        c = self.c
        B, S, _ = x.shape
        H, KV, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
        q = self.rope(self.mm(x, p["wq"]).reshape(B, S, H, hd))
        k = self.rope(self.mm(x, p["wk"]).reshape(B, S, KV, hd))
        v = self.mm(x, p["wv"]).reshape(B, S, KV, hd)
        qg = q.reshape(B, S, KV, H // KV, hd)
        logits = self.ein("bqgrd,bkgd->bgrqk", qg, k) / math.sqrt(hd)
        pos = torch.arange(S, device=x.device)
        rel = pos[:, None] - pos[None, :]
        mask = rel >= 0
        if window is not None:
            mask &= rel < window
        logits = logits.masked_fill(~mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        out = self.ein("bgrqk,bkgd->bqgrd", probs, v).reshape(B, S, H * hd)
        return self.mm(out, p["wo"])

    # ---- mamba ---------------------------------------------------------- #
    def mamba(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        B, S, _ = x.shape
        K, n = c["ssm_conv"], c["ssm_state"]
        u, z = torch.chunk(self.mm(x, p["in_proj"]), 2, dim=-1)
        padded = F.pad(u, (0, 0, K - 1, 0))
        w = p["conv_w"].to(F32)
        conv = sum(w[k] * padded[:, k:k + S] for k in range(K)) + p["conv_b"].to(F32)
        u = F.silu(conv)
        dtr = p["dt_w"].shape[0]
        dt_low, Bm, Cm = torch.split(self.mm(u, p["x_proj"]), [dtr, n, n], dim=-1)
        dt_in = self.mm(dt_low, p["dt_w"]) + p["dt_b"].to(F32)
        dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))
        A = -torch.exp(p["A_log"].to(F32))
        dA = torch.exp(dt[..., None] * A)                          # (B, S, di, n)
        dBu = (dt * u)[..., None] * Bm[:, :, None, :]
        h = torch.zeros((B, u.shape[-1], n), dtype=F32, device=x.device)
        ys = []
        # one unbind a tensor: under autograd its backward stacks the steps'
        # gradients once, where indexing step t would fill a whole-sequence
        # gradient at every step
        for a_t, b_t, c_t in zip(dA.unbind(1), dBu.unbind(1), Cm.unbind(1)):
            h = a_t * h + b_t
            ys.append(torch.einsum("bdn,bn->bd", h, c_t))
        y = torch.stack(ys, dim=1) + p["D"].to(F32) * u
        return self.mm(y * F.silu(z), p["out_proj"])

    # ---- blocks and the stack ------------------------------------------- #
    def block(self, lp: Dict, x: torch.Tensor, window: Optional[int]) -> torch.Tensor:
        c = self.c
        xn = self.rms(x, lp["norm1"]["scale"])
        if c["arch_type"] == "ssm":
            mix = self.mamba(lp["mamba"], xn)
        elif c["arch_type"] == "hybrid":
            a = self.attention(lp["attn"], xn, window)
            m = self.mamba(lp["mamba"], xn)
            mix = 0.5 * (self.rms(a, lp["attn_out_scale"]) + self.rms(m, lp["mamba_out_scale"]))
        else:
            mix = self.attention(lp["attn"], xn, window)
        x = x + mix
        if c["d_ff"]:
            xn = self.rms(x, lp["norm2"]["scale"])
            mp = lp["mlp"]
            x = x + self.mm(F.silu(self.mm(xn, mp["wg"])) * self.mm(xn, mp["wu"]), mp["wd"])
        return x

    def hidden(self, params: Dict, tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """The final hidden states ``(B, S, d)``, after the final norm."""
        x = params["embed"][tokens].to(F32) * math.sqrt(self.c["d_model"])
        names = _layer_paths(params["layers"])
        per_layer = list(zip(*(_get(params["layers"], path).unbind(0) for path in names)))
        for views, win in zip(per_layer, self.windows()):
            lp = _nest(names, views)
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self.block, lp, x, win,
                                                      use_reentrant=False)
            else:
                x = self.block(lp, x, win)
        return self.rms(x, params["final_norm"]["scale"])

    def head(self, params: Dict) -> torch.Tensor:
        return params["head"] if "head" in params else params["embed"].T

    def logits(self, params: Dict, h: torch.Tensor) -> torch.Tensor:
        return self.mm(h, self.head(params))

    def loss(self, params: Dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy over ``labels >= 0``."""
        h = self.hidden(params, tokens, remat=True)
        lf = self.logits(params, h).reshape(-1, self.c["vocab_size"])
        lab = labels.reshape(-1).to(torch.int64)
        keep = lab >= 0
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, 1, lab.clamp(min=0)[:, None])[:, 0]
        return ((lse - gold) * keep).sum() / keep.sum()


def _get(tree: Dict, path):
    for k in path:
        tree = tree[k]
    return tree


def _layer_paths(tree: Dict, prefix=()):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _layer_paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)]
    return out


def _nest(paths, values) -> Dict:
    out: Dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def flatten(tree: Dict):
    """``[(path, leaf)]`` in sorted-key order, as the port flattens a tree."""
    return [(path, _get(tree, path)) for path in _layer_paths(tree)]


def unflatten(items) -> Dict:
    return _nest([p for p, _ in items], [v for _, v in items])
