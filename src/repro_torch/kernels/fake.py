"""The kernels as operators of their own, for tensors without data (the dry run).

``launch.dryrun`` runs a rank's real step on tensors of the ``meta`` device
(a shape, a dtype, no data; a fake tensor of ``torch._subclasses.fake_tensor``
is taken too).  A kernel's ctypes launch needs data pointers, so
``kernels.ops`` hands such a tensor (``no_data``) to the function of the
same name here,
which calls ``torch.ops.repro_torch.<kernel>``: a ``torch.library.custom_op``
whose ``register_fake`` (the operator's meta and fake implementation) gives
the outputs' shapes and dtypes, as the kernel allocates them (an in-place kernel allocates nothing).  As an operator of
its own the kernel is one operation to the dry run's meters: its operands
and results are its bytes, and ``launch.dryrun`` registers flash
attention's count of operations with ``FlopCounterMode``.

These operators have no implementation for data: a real tensor never
reaches them (``kernels.ops`` launches the kernel on a CUDA tensor and runs
the plain version on a CPU one), and calling one on real tensors raises.
``CALLS`` counts the calls per kernel since ``reset_calls``; they are not
launches (``kernels.ops.launch_counts``).  Scalars that only the arithmetic
needs (a perturbation's ``mu``, an update's ``lr``) are not passed; a scale
given as a tensor is, as the operand it is, and so is a per-leaf kernel's
run table (``starts``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels.ref import run_length

CALLS: Dict[str, int] = {k: 0 for k in (
    "zo_perturb_flat", "zo_reconstruct_flat", "zo_perturb_sumsq", "zo_reconstruct_update",
    "zo_perturb", "zo_reconstruct", "zo_sumsq", "flash_attention", "selective_scan",
    "rmsnorm")}


def no_data(t) -> bool:
    """Whether tensor (or device) ``t`` holds no data: the ``meta`` device,
    or a fake tensor."""
    if isinstance(t, Tensor):
        return t.is_meta or is_fake(t)
    return torch.device(t).type == "meta"


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _no_data(*_a, **_kw):
    raise RuntimeError("repro_torch's kernel operators take fake tensors only; "
                       "kernels.ops launches the kernel on real ones")


def _op(name: str, mutates=()):
    """``torch.library.custom_op`` ``repro_torch::name``; its body raises (no
    data), its fake implementation is registered below."""
    return torch.library.custom_op(f"repro_torch::{name}", mutates_args=mutates)


def _scale_operand(scale) -> Optional[Tensor]:
    return scale if isinstance(scale, Tensor) else None


def _check_flat(x: Optional[Tensor], salts: Tensor, ctrs: Tensor, nvalid: Tensor,
                block: int, m: Optional[int] = None) -> int:
    """The flat kernels' metadata and buffer shapes (``zo_direction._meta``)."""
    nb = int(ctrs.shape[0])
    if nb < 1:
        raise ValueError("at least one block is required")
    want = {"salts": (nb,) if m is None else (nb, m), "ctrs": (nb,), "nvalid": (nb,)}
    for name, t in (("salts", salts), ("ctrs", ctrs), ("nvalid", nvalid)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want[name]}")
    if x is not None and (x.dtype != torch.float32 or tuple(x.shape) != (nb * block,)):
        raise ValueError(f"x: {x.dtype} {tuple(x.shape)}, expected float32 ({nb * block},)")
    return nb


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #
@_op("zo_perturb_flat")
def _zo_perturb_flat(x: Tensor, salts: Tensor, ctrs: Tensor, nvalid: Tensor,
                     scale: Optional[Tensor], block: int) -> Tensor:
    _no_data()


@_zo_perturb_flat.register_fake
def _(x, salts, ctrs, nvalid, scale, block):
    _check_flat(x, salts, ctrs, nvalid, block)
    return torch.empty_like(x)


@_op("zo_reconstruct_flat")
def _zo_reconstruct_flat(salts: Tensor, coeffs: Tensor, ctrs: Tensor, nvalid: Tensor,
                         block: int) -> Tensor:
    _no_data()


@_zo_reconstruct_flat.register_fake
def _(salts, coeffs, ctrs, nvalid, block):
    nb = _check_flat(None, salts, ctrs, nvalid, block, int(coeffs.shape[0]))
    return ctrs.new_empty((nb * block,), dtype=torch.float32)


@_op("zo_perturb_sumsq")
def _zo_perturb_sumsq(x: Tensor, salts: Tensor, ctrs: Tensor, nvalid: Tensor,
                      block: int) -> Tuple[Tensor, Tensor]:
    _no_data()


@_zo_perturb_sumsq.register_fake
def _(x, salts, ctrs, nvalid, block):
    _check_flat(x, salts, ctrs, nvalid, block)
    return torch.empty_like(x), x.new_empty((1,))


@_op("zo_reconstruct_update", mutates=("p", "mom"))
def _zo_reconstruct_update(p: Tensor, mom: Optional[Tensor], salts: Tensor, ctrs: Tensor,
                           nvalid: Tensor, bf16_mask: Tensor, coeffs: Tensor,
                           block: int) -> None:
    _no_data()


@_zo_reconstruct_update.register_fake
def _(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, block):
    _check_flat(p, salts, ctrs, nvalid, block, int(coeffs.shape[0]))


@_op("zo_perturb")
def _zo_perturb(x: Tensor, salt: int, scale: Optional[Tensor], offset: int,
                starts: Optional[Tensor]) -> Tensor:
    _no_data()


@_zo_perturb.register_fake
def _(x, salt, scale, offset, starts):
    run_length(x.numel(), starts, offset)
    return torch.empty_like(x)


@_op("zo_reconstruct")
def _zo_reconstruct(n: int, salts: Tensor, coeffs: Tensor, offset: int,
                    starts: Optional[Tensor]) -> Tensor:
    _no_data()


@_zo_reconstruct.register_fake
def _(n, salts, coeffs, offset, starts):
    run_length(n, starts, offset)
    return coeffs.new_empty((n,), dtype=torch.float32)


@_op("zo_sumsq")
def _zo_sumsq(where: Tensor, n: int, salt: int, offset: int) -> Tensor:
    _no_data()


@_zo_sumsq.register_fake
def _(where, n, salt, offset):
    return where.new_empty((), dtype=torch.float32)


@_op("flash_attention")
def _flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: Optional[int],
                     softcap: Optional[float]) -> Tensor:
    _no_data()


@_flash_attention.register_fake
def _(q, k, v, causal, window, softcap):
    _fa.check_inputs(q, k, v, window, softcap)
    return torch.empty_like(q)


@_op("selective_scan")
def _selective_scan(u: Tensor, dt: Tensor, Bmat: Tensor, Cmat: Tensor, A: Tensor,
                    D: Tensor) -> Tensor:
    _no_data()


@_selective_scan.register_fake
def _(u, dt, Bmat, Cmat, A, D):
    _ss.check_inputs(u, dt, Bmat, Cmat, A, D)
    return torch.empty_like(u)


@_op("selective_scan_state")
def _selective_scan_state(u: Tensor, dt: Tensor, Bmat: Tensor, Cmat: Tensor, A: Tensor,
                          D: Tensor) -> Tuple[Tensor, Tensor]:
    _no_data()


@_selective_scan_state.register_fake
def _(u, dt, Bmat, Cmat, A, D):
    _ss.check_inputs(u, dt, Bmat, Cmat, A, D)
    B, _, di = u.shape
    return torch.empty_like(u), u.new_empty((B, di, A.shape[1]), dtype=torch.float32)


@_op("rmsnorm")
def _rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    _no_data()


@_rmsnorm.register_fake
def _(x, scale, eps):
    _rn.check_inputs(x.reshape(-1, x.shape[-1]), scale)
    return torch.empty_like(x)


# --------------------------------------------------------------------------- #
# what kernels.ops calls on a fake tensor: the wrappers' signatures
# --------------------------------------------------------------------------- #
def _count(name: str) -> None:
    CALLS[name] += 1


def zo_perturb_flat(x, salts, ctrs, nvalid, scale, block=4096):
    _count("zo_perturb_flat")
    return _zo_perturb_flat(x, salts, ctrs, nvalid, _scale_operand(scale), block)


def zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block=4096):
    _count("zo_reconstruct_flat")
    return _zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block)


def zo_perturb_sumsq(x, salts, ctrs, nvalid, block=4096):
    _count("zo_perturb_sumsq")
    return _zo_perturb_sumsq(x, salts, ctrs, nvalid, block)


def zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, block=4096):
    _count("zo_reconstruct_update")
    _zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, block)
    return p, mom


def zo_perturb(x, salt, scale, offset=0, starts=None):
    _count("zo_perturb")
    return _zo_perturb(x, int(salt) & 0xFFFFFFFF, _scale_operand(scale),
                       int(offset) & 0xFFFFFFFF, starts)


def zo_reconstruct(n, salts, coeffs, offset=0, starts=None):
    _count("zo_reconstruct")
    return _zo_reconstruct(int(n), salts, coeffs, int(offset) & 0xFFFFFFFF, starts)


def zo_sumsq(n, salt, offset, device):
    _count("zo_sumsq")
    # the kernel has no tensor input: an empty one on ``device`` says where
    return _zo_sumsq(torch.empty(0, device=device), int(n), int(salt) & 0xFFFFFFFF,
                     int(offset) & 0xFFFFFFFF)


def flash_attention(q, k, v, causal=True, window=None, softcap=None):
    _count("flash_attention")
    return _flash_attention(q, k, v, bool(causal),
                            None if window is None else min(int(window), 2 ** 31 - 1),
                            None if softcap is None else float(softcap))


def selective_scan(u, dt, Bmat, Cmat, A, D, return_state=False):
    _count("selective_scan")
    if return_state:
        return _selective_scan_state(u, dt, Bmat, Cmat, A, D)
    return _selective_scan(u, dt, Bmat, Cmat, A, D)


def rmsnorm(x, scale, eps=1e-6):
    _count("rmsnorm")
    return _rmsnorm(x, scale, float(eps))


FLASH_OP = torch.ops.repro_torch.flash_attention
