"""A kernel's share of its roofline: the bound of its calls in the window
(the mean bound of a call over the checked packets, recomputed by the
reference from the same inputs, times the calls traced) over the device
time of its kernels."""


def share(run, family: str, kernels, first):
    """``kernels``: substrings of the family's kernel names; ``first``:
    those that open a call (one a call)."""
    if not run.events or family not in run.calls:
        return None
    time_s = sum(d for n, _, d in run.events if any(k in n for k in kernels))
    calls = sum(1 for n, _, _ in run.events if any(k in n for k in first))
    if not time_s or not calls:
        return None
    return 100.0 * calls * run.calls[family] / 1e3 / time_s
