"""The port's LM kernels, ``flash_attention`` and ``rg_lru_scan``, on the
CPU route (their plain versions) against the JAX package's Pallas
kernels in interpret mode and its oracles, on inputs made from one numpy
seed; and the routes themselves.  The plain oracle the bf16 kernel is held
to on the card (``chip_smoke.attention_rounded_p``, p rounded to bf16)
against numpy.

Tolerances: attention 2e-5 in float32 and 2e-2 in bfloat16 (the JAX
package's own kernel-vs-oracle bounds, ``tests/test_kernels.py``); the
rounded-p oracle 2e-4 of numpy (and its bound, ``rounded_p_excess``, <= 0
on what it must allow); the recurrence rtol 1e-5, atol 1e-6.
The Pallas kernel runs with its default 128-wide tiles (one tile per
sequence here): the port's function has no tiles to sweep, and the JAX
package's own tests sweep the Pallas tiling.
"""
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import attention_ref as j_attention_ref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rg_lru_scan import lru_scan_ref as j_lru_scan_ref
from repro.kernels.rg_lru_scan import rg_lru_scan as j_rg_lru_scan
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.rg_lru_scan import lru_scan_ref, rg_lru_scan
from repro_torch.kernels.rg_lru_scan import kernel as lkernel
from repro_torch.models import attention as tattn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke
import chip_smoke  # noqa: E402


def _np(a):
    return np.asarray(a, np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,H,K,D", [
    (64, 64, 2, 2, 32),    # MHA
    (64, 64, 4, 2, 32),    # GQA
    (32, 96, 2, 1, 64),    # MQA, cross-length
    (50, 70, 2, 2, 32),    # non-multiple lengths
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_flash_attention_matches_jax(dtype, T, S, H, K, D, causal, window):
    if causal and S > T:
        S = T
    B = 2
    rng = np.random.default_rng(T * 1000 + S)
    # round the inputs to the working type once, so both packages get
    # the same values
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal(shape), jdt))
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    tdt = getattr(torch, dtype)
    got = flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal,
                          window=window)
    assert got.dtype == tdt and got.shape == (B, T, H, D)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, interpret=True)
    qh = q.transpose(0, 2, 1, 3).reshape(B * H, T, D)
    kh = k.transpose(0, 2, 1, 3).reshape(B * K, S, D)
    vh = v.transpose(0, 2, 1, 3).reshape(B * K, S, D)
    oracle = j_attention_ref(jnp.asarray(qh), jnp.asarray(kh),
                             jnp.asarray(vh), causal=causal, window=window)
    oracle = _np(oracle).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(got.float()), oracle, rtol=tol, atol=tol)
    # the head-major oracle of the port equals the JAX one too
    ref_h = attention_ref(_t(qh, tdt), _t(kh, tdt), _t(vh, tdt),
                          causal=causal, window=window)
    np.testing.assert_allclose(
        _np(ref_h.float()).reshape(B, H, T, D).transpose(0, 2, 1, 3), oracle,
        rtol=tol, atol=tol)


def _np_attention_rounded_p(q, k, v, causal, window):
    """numpy in float64: the unnormalised p, relative to the row maximum,
    rounded to float32 and then to bf16 (``ml_dtypes``) before the
    product with v, divided by the sum of the unrounded p."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    tpos, spos = np.arange(T)[:, None], np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= spos <= tpos
    if window:
        mask &= tpos - spos < window
    out = np.zeros((B, T, H, D))
    for b in range(B):
        for h in range(H):
            kh = h // (H // K)
            s = np.where(mask, q[b, :, h] @ k[b, :, kh].T / np.sqrt(D), -1e30)
            p = np.exp(s - s.max(-1, keepdims=True))
            pr = p.astype(np.float32).astype(ml_dtypes.bfloat16)
            out[b, :, h] = (pr.astype(np.float64) @ v[b, :, kh]
                            / p.sum(-1, keepdims=True))
    return out


@pytest.mark.parametrize("B,T,S,H,K,D,causal,window", [
    (2, 64, 64, 4, 2, 32, True, 0), (2, 64, 64, 4, 2, 32, True, 24),
    (2, 50, 70, 2, 2, 32, False, 0), (1, 130, 130, 10, 1, 256, True, 50),
    (3, 100, 100, 8, 8, 12, True, 0)])
def test_rounded_p_oracle_matches_numpy(B, T, S, H, K, D, causal, window):
    """``chip_smoke.attention_rounded_p``, the plain oracle the bf16 kernel
    is held to on the card, rounds p to bf16 before the product with V:
    it is within 2e-4 of numpy doing so (a p whose float32 value sits on a
    bf16 rounding edge may round the other way), and 1e-3 or more from
    numpy keeping p unrounded."""
    rng = np.random.default_rng(T * 1000 + S + D)
    q, k, v = (rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    got = chip_smoke.attention_rounded_p(
        torch, *(_t(x, torch.bfloat16) for x in (q, k, v)), causal, window)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    got = got.numpy().astype(np.float64)
    want = _np_attention_rounded_p(q, k, v, causal, window)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    p_in_float32 = attention_ref(*(
        _t(x, torch.float32).transpose(1, 2).reshape(-1, x.shape[1], D)
        for x in (q, k, v)), causal=causal, window=window)
    p_in_float32 = p_in_float32.reshape(B, H, T, D).transpose(1, 2).numpy()
    assert np.abs(got - p_in_float32).max() >= 1e-3


def _np_attention_tile_p(q, k, v, causal, window, tile=64):
    """numpy, row by row and tile by tile as the bf16 kernel's loop: the
    running maximum after each 64-key tile, p relative to it (in float64,
    then float32, then bf16) into the accumulator and the unrounded p into
    the sum, both rescaled when the maximum moves."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    out = np.zeros((B, T, H, D))
    for b in range(B):
        for h in range(H):
            kh = h // (H // K)
            s_all = q[b, :, h] @ k[b, :, kh].T / np.sqrt(D)
            for t in range(T):
                keys = np.arange(S)
                live = np.ones(S, bool)
                if causal:
                    live &= keys <= t
                if window:
                    live &= t - keys < window
                m, acc, lsum = -np.inf, np.zeros(D), 0.0
                for k0 in range(0, S, tile):
                    sl = slice(k0, k0 + tile)
                    if not live[sl].any():
                        continue
                    s = s_all[t, sl][live[sl]]
                    m_new = max(m, s.max())
                    alpha = np.exp(m - m_new)
                    p = np.exp(s - m_new)
                    pr = p.astype(np.float32).astype(ml_dtypes.bfloat16)
                    acc = acc * alpha + pr.astype(np.float64) @ v[
                        b, k0:k0 + tile, kh][live[sl]]
                    lsum = lsum * alpha + p.sum()
                    m = m_new
                out[b, t, h] = acc / lsum
    return out


@pytest.mark.parametrize("B,T,S,H,K,D,causal,window", [
    (1, 200, 200, 4, 2, 32, True, 0), (1, 150, 150, 6, 1, 16, True, 70),
    (2, 40, 130, 2, 2, 32, False, 0), (1, 64, 64, 4, 4, 16, True, 0)])
def test_tile_p_oracle_matches_numpy(B, T, S, H, K, D, causal, window):
    """``chip_smoke.attention_tile_p`` rounds p as the bf16 kernel does,
    relative to the running maximum after each 64-key tile: within 2e-4
    of a numpy loop over the tiles, and where every row's keys lie in one
    tile (64 keys) within 2e-6 of ``attention_rounded_p``."""
    rng = np.random.default_rng(T * 1000 + S + D + window)
    q, k, v = (rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
               for shape in ((B, T, H, D), (B, S, K, D), (B, S, K, D)))
    args = [_t(x, torch.bfloat16) for x in (q, k, v)]
    got = chip_smoke.attention_tile_p(torch, *args, causal, window)
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    want = _np_attention_tile_p(q, k, v, causal, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    if S <= 64:
        row = chip_smoke.attention_rounded_p(torch, *args, causal, window)
        torch.testing.assert_close(got, row, rtol=2e-6, atol=2e-6)
    err, excess = chip_smoke.tile_p_excess(torch, got.to(torch.bfloat16),
                                           *args, causal, window)
    assert err > 0 and excess <= 0


def test_rounded_p_oracle_is_the_plain_version_in_float32():
    """On float32 inputs the rounding is a no-op: the oracle equals
    ``flash_attention_ref`` within 1e-6."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal(shape), torch.float32)
               for shape in ((2, 90, 4, 40), (2, 90, 2, 40), (2, 90, 2, 40)))
    got = chip_smoke.attention_rounded_p(torch, q, k, v, True, 30)
    want = flash_attention_ref(q, k, v, causal=True, window=30)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_rounded_p_excess_allows_the_two_roundings():
    """``chip_smoke.rounded_p_excess`` leaves nothing beyond its bound for
    the oracle's own output rounded to bf16, nor for the plain version's
    (p kept in float32, less than a bf16 step of p away), and reports an
    error of 0.05 in one element."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.standard_normal(shape), torch.bfloat16)
               for shape in ((2, 150, 4, 32), (2, 150, 2, 32), (2, 150, 2, 32)))
    o = chip_smoke.attention_rounded_p(torch, q, k, v, True, 70)
    for got in (o.to(torch.bfloat16),
                flash_attention_ref(q, k, v, causal=True, window=70)):
        err, excess = chip_smoke.rounded_p_excess(torch, got, q, k, v, True,
                                                  70)
        assert err > 0 and excess <= 0
    bad = o.clone()
    bad[1, 100, 3, 7] += 0.05
    _, excess = chip_smoke.rounded_p_excess(torch, bad, q, k, v, True, 70)
    assert excess > 0.04


@pytest.mark.parametrize("B,T,W", [(1, 16, 32), (2, 33, 64), (3, 8, 48),
                                   (4, 1, 40)])
def test_rg_lru_scan_matches_jax(B, T, W):
    rng = np.random.default_rng(B * 100 + T)
    a = rng.uniform(0.7, 0.999, (B, T, W)).astype(np.float32)
    b = (rng.standard_normal((B, T, W)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    h, hl = rg_lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(h0))
    jh, jhl = j_rg_lru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                            interpret=True)
    rh, rhl = j_lru_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    for got, want in ((h, jh), (hl, jhl), (h, rh), (hl, rhl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    rh2, rhl2 = lru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(h0))
    assert torch.equal(rh2, h) and torch.equal(rhl2, hl)


def test_cpu_route_takes_plain_versions():
    """CPU tensors take the plain versions: no launch is counted, and the
    kernels' own launchers refuse CPU tensors."""
    f0, l0 = fkernel.launches, lkernel.launches
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    flash_attention(q, k, k)
    rg_lru_scan(torch.rand(1, 4, 8), torch.randn(1, 4, 8), torch.zeros(1, 8))
    assert (fkernel.launches, lkernel.launches) == (f0, l0)
    with pytest.raises(ValueError, match="CUDA"):
        fkernel.flash_attention_fwd(q, k, k, causal=True, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        lkernel.lru_scan(torch.rand(1, 4, 8), torch.randn(1, 4, 8),
                         torch.zeros(1, 8))
    assert (fkernel.launches, lkernel.launches) == (f0, l0)


def test_bad_shapes_and_options_raise():
    q = torch.randn(1, 8, 3, 16)
    k = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)            # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        rg_lru_scan(torch.rand(1, 4, 8), torch.rand(1, 4, 8),
                    torch.zeros(2, 8))
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    with pytest.raises(NotImplementedError, match="soft-cap"):
        tattn.chunked_attention(q, k, k, causal=True, softcap=30.0)
    with pytest.raises(NotImplementedError, match="q_offset"):
        tattn.chunked_attention(q, k, k, causal=True, q_offset=4)
    with pytest.raises(ValueError, match="attn_impl"):
        tattn.chunked_attention(q, k, k, causal=True, impl="mosaic")
    for impl in tattn.ATTN_IMPLS:           # every impl is the one function
        assert torch.equal(
            tattn.chunked_attention(q, k, k, causal=True, window=3,
                                    impl=impl),
            flash_attention(q, k, k, causal=True, window=3))
