"""ctypes binding of the CUDA kernels in ``csrc/zo_direction.cu``.

Counterpart of ``repro.kernels.zo_direction``: the four flat kernels and the
per-leaf ``zo_perturb``, ``zo_reconstruct`` and ``zo_sumsq``.  Each
function here takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch was refused.  There is no fallback:
the plain versions live in ``repro_torch.kernels.ref`` and
``repro_torch.kernels.ops`` picks between the two by the tensors' device.

The library is built (``kernels.build``) and loaded at the first launch, never
at import (``kernels.binding``).  ``LAUNCHES`` counts kernel launches per
function, and only here, where they happen; ``LAUNCHES_PER_CALL`` says how
many one call makes (two for ``zo_perturb_sumsq`` and ``zo_sumsq``, one for
every other function).

``zo_reconstruct_flat`` and ``zo_reconstruct_update`` run one kernel, which
stores the m-worker sum or commits it to ``p``.  Each sum of squares is two
launches: one partial sum per block of a grid that the card holds at once
(at most ``MAX_PARTIALS`` blocks), then a programmatic dependent launch that
sums the partials in one fixed order, the same result run to run.

A leaf's salt and counter offset are Python ints and go to the kernel by
value, as do ``zo_perturb_sumsq``'s ``mu`` and ``zo_reconstruct_update``'s
``lr`` (host numbers: every caller has one, a schedule's value is a CPU
tensor, and no fill kernel runs for them; ``_host_f32``); any other scale is
read from device memory (``_scalar``), so a scale computed on the card is
never synced to the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.dtypes import acc_dtype_of
from repro_torch.kernels.binding import check as _check
from repro_torch.kernels.binding import cuda_device as _cuda_device
from repro_torch.kernels.binding import launch, library
from repro_torch.kernels.binding import stream as _stream

LAUNCHES = {"zo_perturb_flat": 0, "zo_reconstruct_flat": 0,
            "zo_perturb_sumsq": 0, "zo_reconstruct_update": 0,
            "zo_perturb": 0, "zo_reconstruct": 0, "zo_sumsq": 0,
            "zo_check_gauss": 0, "zo_probe_part": 0}
LAUNCHES_PER_CALL = {k: 1 for k in LAUNCHES} | {"zo_perturb_sumsq": 2, "zo_sumsq": 2}
MAX_PARTIALS = 2048   # the sums of squares' partial sums: cap their first grid
LEAF_DTYPES = (torch.float32, torch.bfloat16)

_P, _I64, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
_U32 = ctypes.c_uint32
_SIGNATURES = {
    "zo_perturb_flat_launch": [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
    "zo_reconstruct_flat_launch": [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P],
    "zo_sumsq_v_launch": [_P, _P, _P, _P, _P, _P, _I, _I64, _I, _I, _P],
    "zo_apply_v_launch": [_P, _P, _P, _I, _F, _P, _P, _I64, _I, _P],
    "zo_reconstruct_update_launch": [_P, _P, _P, _P, _P, _P, _P, _F, _F, _I64, _I,
                                     _I, _I, _I, _P],
    "zo_perturb_leaf_launch": [_P, _P, _I64, _U32, _U32, _P, _I, _I, _P],
    "zo_reconstruct_leaf_launch": [_P, _P, _P, _I64, _U32, _I, _I, _I, _P],
    "zo_sumsq_partials_launch": [_P, _I, _I64, _U32, _U32, _I, _P],
    "zo_sumsq_total_launch": [_P, _I, _I64, _P, _I, _P],
    "zo_check_gauss_launch": [_P, _I, _I, _P],
    "zo_probe_part_launch": [_P, _I64, _I, _I, _U32, _I, _P],
}


def _launch(counter: str, entry: str, *args) -> None:
    launch(library("zo_direction", _SIGNATURES), LAUNCHES, counter, entry, *args)


def _scalar(v, device: torch.device) -> torch.Tensor:
    """A float32 (1,) tensor on the card; the kernels read scalars from
    device memory, so a value computed on the card is never synced to the
    host, and a host value is written by a fill kernel, not a blocking copy."""
    if isinstance(v, torch.Tensor) and v.device == device:
        return v.to(torch.float32).reshape(1).contiguous()
    return torch.full((1,), float(v), dtype=torch.float32, device=device)


def _host_f32(v, what: str) -> float:
    """``v`` as the float32 number a kernel takes by value: a Python number
    or a one-value CPU tensor (a schedule's value), rounded to float32 as
    ``c_float`` passes it.  A tensor on any other device raises TypeError:
    reading it would sync the host with the card."""
    if isinstance(v, torch.Tensor):
        if v.device.type != "cpu":
            raise TypeError(f"{what}: taken by value; give a host number or a CPU "
                            f"tensor, not a tensor on {v.device}")
        v = v.item()
    return _F(float(v)).value


def _aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An empty contiguous tensor shaped and typed like ``x`` whose data has
    x's alignment mod 16 bytes, so that a kernel's 16-byte accesses line up
    in both (a fresh allocation is 16-byte aligned; a view of one need not
    be)."""
    shift = (x.data_ptr() % 16) // x.element_size()
    if shift == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    flat = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    return flat[shift:].view(x.shape)


def _meta(salts, ctrs, nvalid, device, m=None):
    nb = int(ctrs.shape[0])
    if nb < 1:
        raise ValueError("at least one block is required")
    sshape = (nb,) if m is None else (nb, m)
    return (nb,
            _check(salts, "salts", torch.uint32, device, sshape),
            _check(ctrs, "ctrs", torch.uint32, device, (nb,)),
            _check(nvalid, "nvalid", torch.int32, device, (nb,)))


def zo_perturb_flat(x, salts, ctrs, nvalid, scale, block: int = 4096):
    """Whole-buffer ``x + scale * v`` (padding lanes unchanged); one launch.
    ``scale`` may be a tensor on the card (read there) or a host number; the
    output has x's alignment mod 16 bytes, so both take 16-byte accesses."""
    dev = _cuda_device(x)
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev)
    px = _check(x, "x", torch.float32, dev, (nb * block,))
    sc = _scalar(scale, dev)
    out = _aligned_like(x)
    _launch("zo_perturb_flat", "zo_perturb_flat_launch", px, ps, pc, pn,
            sc.data_ptr(), out.data_ptr(), x.numel(), block, dev.index,
            _stream(dev))
    return out


def zo_reconstruct_flat(salts, coeffs, ctrs, nvalid, block: int = 4096,
                        acc_dtype="float32"):
    """Whole-buffer ``sum_w coeffs[w] * v_w``; padding lanes 0; one launch
    of zo_reconstruct_update's kernel with a store in place of the commit."""
    dev = _cuda_device(ctrs)
    m = int(coeffs.shape[0])
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev, m)
    pco = _check(coeffs, "coeffs", torch.float32, dev, (m,))
    acc_bf16 = int(acc_dtype_of(acc_dtype) == torch.bfloat16)
    out = torch.empty(nb * block, dtype=torch.float32, device=dev)
    _launch("zo_reconstruct_flat", "zo_reconstruct_flat_launch", ps, pco, pc,
            pn, out.data_ptr(), out.numel(), block, m, acc_bf16, dev.index,
            _stream(dev))
    return out


def zo_perturb_sumsq(x, salts, ctrs, nvalid, mu, block: int = 4096):
    """``(x + mu*rsqrt(sum v^2)*v, sum v^2)``, ``sum v^2`` a (1,) tensor:
    two launches, each Gaussian computed once into a scratch buffer with one
    partial sum of v^2 per block, then a fixed-order sum of the partials and
    the stream of x and v.  ``mu`` is a host number, passed by value."""
    dev = _cuda_device(x)
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev)
    px = _check(x, "x", torch.float32, dev, (nb * block,))
    mu = _host_f32(mu, "mu")
    out, v = _aligned_like(x), _aligned_like(x)
    partials = torch.empty(MAX_PARTIALS, dtype=torch.float32, device=dev)
    ss = torch.empty(1, dtype=torch.float32, device=dev)
    stream = _stream(dev)
    _launch("zo_perturb_sumsq", "zo_sumsq_v_launch", px, ps, pc, pn, v.data_ptr(),
            partials.data_ptr(), MAX_PARTIALS, x.numel(), block, dev.index, stream)
    _launch("zo_perturb_sumsq", "zo_apply_v_launch", px, v.data_ptr(), partials.data_ptr(),
            MAX_PARTIALS, mu, out.data_ptr(), ss.data_ptr(), x.numel(), dev.index, stream)
    return out, ss


def zo_reconstruct_update(p, mom, salts, ctrs, nvalid, bf16_mask, coeffs, lr,
                          momentum: float = 0.0, block: int = 4096,
                          acc_dtype="float32"):
    """Fused reconstruct + SGD(+momentum) commit, IN PLACE on ``p`` (and
    ``mom``); returns ``(p, mom)``.  The caller owns both buffers: no tree
    visible to a user may alias them (FlatEngine packs a fresh copy).
    ``lr`` is a host number or a CPU tensor, passed by value."""
    dev = _cuda_device(p)
    m = int(coeffs.shape[0])
    nb, ps, pc, pn = _meta(salts, ctrs, nvalid, dev, m)
    pp = _check(p, "p", torch.float32, dev, (nb * block,))
    pm = None if mom is None else _check(mom, "mom", torch.float32, dev, (nb * block,))
    pb = _check(bf16_mask, "bf16_mask", torch.int32, dev, (nb,))
    pco = _check(coeffs, "coeffs", torch.float32, dev, (m,))
    lr = _host_f32(lr, "lr")
    acc_bf16 = int(acc_dtype_of(acc_dtype) == torch.bfloat16)
    _launch("zo_reconstruct_update", "zo_reconstruct_update_launch", pp, pm,
            ps, pc, pn, pb, pco, lr, float(momentum), p.numel(),
            block, m, acc_bf16, dev.index, _stream(dev))
    return p, mom


# --------------------------------------------------------------------------- #
# per-leaf kernels
# --------------------------------------------------------------------------- #
def _leaf_size(n) -> int:
    n = int(n)
    if n < 1:
        raise ValueError(f"a leaf needs at least one value, got n={n}")
    return n


def _u32(v) -> int:
    """A salt or counter offset as the uint32 word the kernel takes."""
    return int(v) & 0xFFFFFFFF


def zo_perturb(x, salt, scale, offset=0):
    """``(f32(x) + scale * v).to(x.dtype)`` for one flat leaf of float32 or
    bfloat16 values, out of place; one launch.  The output has x's alignment
    mod 16 bytes, so a view of a leaf (``x[1:]``) still takes the kernel's
    16-byte accesses."""
    dev = _cuda_device(x)
    if x.dtype not in LEAF_DTYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected one of {LEAF_DTYPES}")
    n = _leaf_size(x.numel())
    px = _check(x, "x", x.dtype, dev, (n,))
    sc = _scalar(scale, dev)
    out = _aligned_like(x)
    _launch("zo_perturb", "zo_perturb_leaf_launch", px, out.data_ptr(), n,
            _u32(salt), _u32(offset), sc.data_ptr(), int(x.dtype == torch.bfloat16),
            dev.index, _stream(dev))
    return out


def zo_reconstruct(n, salts, coeffs, offset=0, acc_dtype="float32"):
    """``sum_w coeffs[w] * v_w`` for one leaf of ``n`` values (float32), the
    accumulator rounded to ``acc_dtype`` after each worker; ``salts`` is a
    (m,) uint32 and ``coeffs`` a (m,) float32 tensor on the card; one launch."""
    dev = _cuda_device(coeffs)
    n = _leaf_size(n)
    m = int(coeffs.shape[0])
    pco = _check(coeffs, "coeffs", torch.float32, dev, (m,))
    ps = _check(salts, "salts", torch.uint32, dev, (m,))
    acc_bf16 = int(acc_dtype_of(acc_dtype) == torch.bfloat16)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _launch("zo_reconstruct", "zo_reconstruct_leaf_launch", ps, pco, out.data_ptr(),
            n, _u32(offset), m, acc_bf16, dev.index, _stream(dev))
    return out


def zo_sumsq(n, salt, offset=0, device="cuda"):
    """``sum v^2`` over one hashed-Gaussian leaf of ``n`` values (counters
    ``offset + i`` wrapping mod 2^32), a 0-d float32 tensor on ``device``:
    one partial sum per block, then one fixed-order sum of the partials in
    a programmatic dependent launch (two launches; the same result run to
    run)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = _leaf_size(n)
    partials = torch.empty(MAX_PARTIALS, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    stream = _stream(dev)
    _launch("zo_sumsq", "zo_sumsq_partials_launch", partials.data_ptr(), MAX_PARTIALS, n,
            _u32(salt), _u32(offset), dev.index, stream)
    _launch("zo_sumsq", "zo_sumsq_total_launch", partials.data_ptr(), MAX_PARTIALS, n,
            out.data_ptr(), dev.index, stream)
    return out


def check_gauss(device="cuda", control: bool = False):
    """``(radii, cosines)``: how many of the 2^24 values each uniform can take
    give a different radius ``sqrtf(-2 logf(u1))`` or cosine ``cosf(2 pi u2)``
    in the kernels' Gaussian than in libdevice's functions; ``(0, 0)`` proves
    the Gaussian bit for bit.  ``control`` holds the cosines against cosf one
    ulp further on, which must differ.  One launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    bad = torch.zeros(2, dtype=torch.int32, device=dev)
    _launch("zo_check_gauss", "zo_check_gauss_launch", bad.data_ptr(), int(control),
            dev.index, _stream(dev))
    radii, cosines = bad.tolist()
    return radii, cosines


PROBE_PARTS = {"loop": 0, "hashes": 1, "uniforms": 2, "log_sqrt": 3, "cos": 4, "gauss": 5}
# a NaN's bits: no float part gives them, a hash once in 2^32 lanes (which
# only writes the probe's scratch)
PROBE_KEY = 0x7FC12345


def probe_part(n: int, part: str, k: int = 4, device="cuda") -> None:
    """A timing probe: one part of the Gaussian (``PROBE_PARTS``) on ``n``
    lanes, ``k`` per thread and trip (1, 2, 4 or 8 for ``"gauss"``, 4 for
    every other part), on zo_perturb's grid with no load and no store.  One
    launch."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the CUDA kernels take a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = _leaf_size(n)
    sink = torch.empty(max(1, n // k), dtype=torch.float32, device=dev)
    _launch("zo_probe_part", "zo_probe_part_launch", sink.data_ptr(), n, PROBE_PARTS[part], k,
            PROBE_KEY, dev.index, _stream(dev))
