"""The chip's peaks and the ZO kernels' bound, frozen here with their sources.

The bound of a kernel is the larger of its bytes over the memory's rate and
its operations over the issue rate.  Neither number is read from the build
under test: a later change to the kernels cannot move its own yardstick.
"""
from __future__ import annotations

#: NVIDIA H100 SXM5 data sheet, dense bf16 tensor-core rate (no sparsity), at 700 W
BF16_FLOPS = 989e12
#: the same data sheet: HBM3 bandwidth
HBM_BYTES = 3.35e12
#: lane instructions a second: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz boost
ISSUE_RATE = 33.5e12
#: SASS instructions of one hashed Gaussian (two counter hashes, two uniforms,
#: logf, sqrtf, cosf), counted on the card for the port's zo_direction kernels
#: (PERF.md section 2, PRs 17-19), frozen
GAUSS_INSTRUCTIONS = 75


def zo_perturb_bound_s(d: int) -> float:
    """``x + s v`` over d float32 values: d read and d written, one Gaussian each."""
    return max(8.0 * d / HBM_BYTES, GAUSS_INSTRUCTIONS * d / ISSUE_RATE)


def zo_reconstruct_bound_s(d: int, m: int) -> float:
    """``sum_w c_w v_w`` over d values for m workers: d float32 written, m
    Gaussians a value."""
    return max(4.0 * d / HBM_BYTES, GAUSS_INSTRUCTIONS * m * d / ISSUE_RATE)
