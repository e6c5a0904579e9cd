"""The flat ZO kernels' share of their bound, in %: the sum over the traced
window's launches of ``perturb_flat_kernel`` (``zo_perturb_flat``) and
``reconstruct_kernel`` (``zo_reconstruct_flat``) of each launch's bound
(``harness.peaks``: bytes read once and written once over HBM's rate, or one
Gaussian's 75 instructions a value and worker over the issue rate, the
larger), over their device time in the profiler's trace."""


def read(run):
    tr, bounds = run.get("trace"), run.get("zo_bounds_s")
    if not tr or not bounds:
        return None
    bound = took = 0.0
    for name, (secs, count) in tr["kernels"].items():
        for kernel, per_launch in bounds.items():
            if kernel in name:
                bound += per_launch * count
                took += secs
    return 100.0 * bound / took if took > 0 else None
