"""The closed-form cost of one ``rg_lru_scan`` launch (the forward, or
the time-reversed recurrence of its gradient, the same kernel).

``chip_smoke.py``'s bounds and ``launch/dryrun.py``'s counts read it.
"""
from __future__ import annotations


def scan_cost(shape, itemsize: int = 4) -> tuple:
    """``(operations, bytes)`` of one launch on ``a, b [B, T, W]`` and
    ``h0 [B, W]``: a multiply and an add an element; ``a`` and ``b`` read
    and ``h`` written, ``h0`` read and ``h_last`` written, once each."""
    B, T, W = shape
    return 2 * B * T * W, (3 * B * T * W + 2 * B * W) * itemsize
