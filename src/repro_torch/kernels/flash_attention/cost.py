"""The closed-form cost of one ``flash_attention`` launch: the query-key
pairs it computes, its operations and the bytes it must move.

``chip_smoke.py``'s bounds and ``launch/dryrun.py``'s counts read these
functions; the tests hold :func:`live_pairs` to a loop over the queries.
"""
from __future__ import annotations


def _ramp_sum(t0: int, t1: int, c: int, d: int) -> int:
    """``sum(max(0, c + d t) for t in range(t0, t1))`` for ``d`` in
    ``{-1, 0, 1}``."""
    if t1 <= t0:
        return 0
    if d == 0:
        return (t1 - t0) * max(0, c)
    if d > 0:                       # c + t > 0 from t > -c on
        lo = max(t0, -c)
        n = t1 - lo
        return n * c + (lo + t1 - 1) * n // 2 if n > 0 else 0
    hi = min(t1, c + 1)             # c - t >= 0 up to t = c
    n = hi - t0
    return n * c - (t0 + hi - 1) * n // 2 if n > 0 else 0


def live_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """Query-key pairs an attention of ``T`` queries over ``S`` keys
    computes: key ``s`` is live for query ``t`` when ``s <= t`` (causal)
    and ``t - s < window`` (a window): the sum over ``t`` of ``max(0,
    hi(t) - lo(t))`` with ``hi(t) = min(t + 1, S)`` (causal) or ``S``
    and ``lo(t) = max(0, t - window + 1)`` (a window) or ``0``, in the
    linear pieces between their breakpoints."""
    cuts = {0, T}
    if causal:
        cuts.add(min(max(S - 1, 0), T))
    if window:
        cuts.add(min(max(window - 1, 0), T))
    cuts = sorted(cuts)
    n = 0
    for a, b in zip(cuts, cuts[1:]):
        # on [a, b): hi = t + 1 (causal, t + 1 < S) or S; lo = t - w + 1
        # (t >= w - 1) or 0
        c, d = 0, 0
        if causal and a + 1 < S:
            c, d = 1, 1
        else:
            c = S
        if window and a >= window - 1:
            c, d = c + window - 1, d - 1
        n += _ramp_sum(a, b, c, d)
    return n


def flash_cost(q_shape, k_shape, itemsize: int, causal: bool,
               window: int) -> tuple:
    """``(operations, bytes)`` of one launch on ``q [B, T, H, D]`` and ``k,
    v [B, S, K, D]`` of ``itemsize`` bytes an element: ``4 D`` operations
    (a multiply and an add in ``q k`` and in ``p v``) a head and live
    pair; ``q``, ``k`` and ``v`` read once and ``o`` written once."""
    B, T, H, D = q_shape
    S, K = k_shape[1], k_shape[2]
    ops = 4 * D * H * B * live_pairs(T, S, causal, window)
    n_bytes = (2 * B * T * H * D + 2 * B * S * K * D) * itemsize
    return ops, n_bytes
