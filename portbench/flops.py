"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of the model and of each kernel, from shapes alone.

Frozen here so that no later change to the program moves them.  The model's
operations are what the algorithm needs, with no recompute: a training
step is 6·N·tokens over the parameters its products read plus three
attention forwards (forward, and a backward of twice that), a serving step
2·N over the rows each product really runs on plus one attention forward;
causal attention counts half its pairs.  A kernel's bound counts each
input byte read once and each output byte written once.  What depends on
the model's layers is its family's (`families/<family>.py`), which these
functions hand on to; the DR kernels' bounds are any family's.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time: operations at the peak or bytes at HBM's rate."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def _family(a):
    from portbench import arch

    return arch.family(a.family)


def frontend_in(a) -> int:
    return a.dr_frontend.n if a.dr_frontend is not None else a.frontend_dim


def train_flops(a, batch: int, s: int) -> float:
    """One training step on `batch` sequences of s positions (the family's)."""
    return _family(a).train_flops(a, batch, s)


def prefill_flops(a, batch: int, s: int, prefix_rows: int) -> float:
    """One prefill of `batch` streams of s positions, of which `prefix_rows`
    a stream come through the front-end projection (the family's)."""
    return _family(a).prefill_flops(a, batch, s, prefix_rows)


def decode_flops(a, batch: int, s: int, steps: int) -> float:
    """`steps` decode steps of `batch` streams after a prompt of s (the
    family's)."""
    return _family(a).decode_flops(a, batch, s, steps)


def flash_bound_s(a, batch: int, s: int, lse: bool) -> float:
    """B4's least time a launch on one layer (the family's)."""
    return _family(a).flash_bound_s(a, batch, s, lse)


def fused_transform_bound_s(rows: int, m: int, p: int, n: int) -> float:
    """B1: x (rows, m) f32 through the ternary R (p, m), s = p, so each
    output sums about m / p nonzeros (rows · m adds in all), then B (n, p)."""
    flops = rows * m + 2.0 * rows * p * n
    nbytes = F32 * rows * m + p * m + F32 * n * p + F32 * rows * n
    return bound_s(flops, nbytes, PEAK_F32_FLOPS)


def ternary_matmul_bound_s(rows: int, m: int, p: int) -> float:
    """B3: x (rows, m) f32 through the ternary R (p, m), s = p."""
    return bound_s(float(rows * m), F32 * rows * m + p * m + F32 * rows * p, PEAK_F32_FLOPS)


def easi_bound_s(rows: int, n: int, p: int, second_order: bool) -> float:
    """B2 from y (rows, n): the cubic's 2 · rows · n, g(y)ᵀy and, with the
    whitening term, yᵀy at 2 · rows · n² each, then G B (2 · n² · p) and
    the update of B (2 · n · p); y and B read, B written, in f32."""
    flops = 2.0 * rows * n + 2.0 * rows * n * n * (2 if second_order else 1)
    flops += 2.0 * n * n * p + 2.0 * n * p
    return bound_s(flops, F32 * (rows * n + 2 * n * p), PEAK_F32_FLOPS)
