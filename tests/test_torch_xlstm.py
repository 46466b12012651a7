"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's, on the CPU.

Parameters are made by ``repro.models.common.materialize`` at a seed and
carried across (``convert.params_from_jax``); inputs and states are made
from one numpy seed and fed to both packages.  The config is the reduced
``xlstm-1.3b`` (d_model 64, 4 heads, mLSTM inner width 128) in float32.

Tolerances are the JAX package's own tests' (``tests/test_recurrent.py``):
the chunkwise mLSTM within rtol 1e-4 / atol 1e-5 of the JAX package's at
the same chunk length and of the sequential oracle; the streamed mLSTM
within rtol 1e-3 / atol 1e-4 and the streamed sLSTM within rtol 1e-5 /
atol 1e-6; a decode step and the states within rtol 1e-4 / atol 1e-5
(float32, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro.models.common import materialize
from repro.utils.pytree import tree_flatten_with_paths as j_flatten
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttransformer
from repro_torch.models import xlstm as txlstm
from repro_torch.utils.pytree import tree_flatten_with_paths

NAME = "xlstm-1.3b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs():
    return (ARCHS[NAME].reduced().replace(param_dtype="float32",
                                          compute_dtype="float32"),
            tconfigs.get_config(NAME).reduced().replace(
                param_dtype="float32", compute_dtype="float32"))


def _params(shapes_fn, seed=0):
    jcfg, _ = _cfgs()
    jp = materialize(shapes_fn(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, T, seed=2):
    jcfg, _ = _cfgs()
    x = np.random.default_rng(seed).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _states(jst, tst, **tol):
    assert sorted(jst) == sorted(tst)
    for key in jst:
        _close(tst[key], jst[key], **tol)


def _random_state(shapes, seed):
    """A nonzero recurrent state (as numpy) of ``shapes``' leaves: the
    stabiliser ``m`` in [-2, 2], ``n`` and ``c`` positive."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, s in shapes.items():
        a = rng.standard_normal(s.shape).astype(np.float32)
        if key in ("n", "c"):
            a = np.abs(a) + 0.5
        elif key == "m":
            a = np.clip(a, -2, 2)
        out[key] = a
    return out


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 256])
def test_mlstm_chunkwise_matches_jax_and_the_oracle(chunk, monkeypatch):
    """``mlstm_apply`` at chunk length ``chunk`` (256: the default, one
    chunk here) against the JAX package's at the same length and against
    the port's sequential oracle, which is held to the JAX oracle."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.mlstm_shapes)
    jx, tx = _x(2, 8)
    monkeypatch.setattr(jxlstm, "CHUNK", chunk)
    monkeypatch.setattr(txlstm, "CHUNK", chunk)
    jout, _ = jxlstm.mlstm_apply(jp, jx, cfg=jcfg)
    tout, _ = txlstm.mlstm_apply(tp, tx, cfg=tcfg)
    _close(tout, jout)
    toracle = txlstm.mlstm_sequential_oracle(tp, tx, cfg=tcfg)
    _close(tout, toracle.numpy())
    _close(toracle, jxlstm.mlstm_sequential_oracle(jp, jx, cfg=jcfg))


@pytest.mark.parametrize("T", [64, 256])
def test_mlstm_gradient_is_finite_where_the_chunk_overflows_exp(
        T, monkeypatch):
    """One chunk of ``T`` tokens (the default ``CHUNK``): above the
    diagonal of the intra-chunk ``[L, L]`` matrix ``logD`` overflows
    ``exp`` from L = 64 on.  The port masks it before the ``exp`` (the
    JAX package after, and its gradient is NaN there), so the gradient
    of ``sum(out * ct)`` by ``x`` and by every parameter is finite, and
    within 1e-4 of each one's norm of the JAX package's at chunks of 8,
    where no entry overflows (the chunk length changes only the
    rounding)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.mlstm_shapes)
    jx, tx = _x(2, T, seed=T)
    ct = np.random.default_rng(3).standard_normal(
        (2, T, jcfg.d_model)).astype(np.float32)
    tp = {k: v.requires_grad_() if isinstance(v, torch.Tensor)
          else {kk: vv.requires_grad_() for kk, vv in v.items()}
          for k, v in tp.items()}
    tx.requires_grad_()
    tout, _ = txlstm.mlstm_apply(tp, tx, cfg=tcfg)
    (tout * torch.from_numpy(ct)).sum().backward()
    monkeypatch.setattr(jxlstm, "CHUNK", 8)
    jgx, jgp = jax.grad(lambda x, p: jnp.sum(
        jxlstm.mlstm_apply(p, x, cfg=jcfg)[0] * ct), argnums=(0, 1))(jx, jp)
    got = [("x", tx.grad)] + [(q, g.grad) for q, g in
                              tree_flatten_with_paths(tp)]
    want = [("x", jgx)] + list(j_flatten(jgp))
    assert [q for q, _ in got] == [q for q, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), path
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path


def test_mlstm_chunk_rule_halves_to_a_divisor(monkeypatch):
    """T = 12 with CHUNK 8 runs chunks of 4 (the rule ``while T % L: L
    //= 2``), an odd T chunks of 1; ``unroll`` changes nothing."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.mlstm_shapes)
    monkeypatch.setattr(jxlstm, "CHUNK", 8)
    monkeypatch.setattr(txlstm, "CHUNK", 8)
    seen = []
    real = txlstm._mlstm_chunk

    def spy(carry, qkvif):
        seen.append(qkvif[0].shape[1])
        return real(carry, qkvif)

    monkeypatch.setattr(txlstm, "_mlstm_chunk", spy)
    for T, L in ((12, 4), (7, 1)):
        seen.clear()
        jx, tx = _x(2, T, seed=T)
        tout, _ = txlstm.mlstm_apply(tp, tx, cfg=tcfg)
        assert seen == [L] * (T // L)
        _close(tout, jxlstm.mlstm_apply(jp, jx, cfg=jcfg)[0])
        assert torch.equal(txlstm.mlstm_apply(tp, tx, cfg=tcfg,
                                              unroll=True)[0], tout)


def test_mlstm_streaming_state_matches_jax():
    """7 + 5 tokens with the carried state (the conv tail included)
    against the JAX package streamed the same way, and against the
    port's whole-sequence output."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.mlstm_shapes)
    jx, tx = _x(2, 12)
    jst = jtransformer._zero_state(jxlstm.mlstm_state_shapes(jcfg, 2))
    tst = ttransformer._zero_state(txlstm.mlstm_state_shapes(tcfg, 2),
                                   "cpu")
    outs = []
    for sl in (slice(0, 7), slice(7, 12)):
        jo, jst = jxlstm.mlstm_apply(jp, jx[:, sl], cfg=jcfg, state=jst)
        to, tst = txlstm.mlstm_apply(tp, tx[:, sl], cfg=tcfg, state=tst)
        _close(to, jo)
        _states(jst, tst)
        outs.append(to)
    full, none = txlstm.mlstm_apply(tp, tx, cfg=tcfg)
    assert none is None
    _close(torch.cat(outs, 1), full.numpy(), rtol=1e-3, atol=1e-4)


def test_mlstm_decode_matches_jax():
    """Three O(1) steps from a nonzero state, against the JAX package's
    ``_mlstm_decode``; ``mlstm_apply`` with T = 1 and a state is that
    step."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.mlstm_shapes)
    st = _random_state(jxlstm.mlstm_state_shapes(jcfg, 2), 5)
    jst = jax.tree.map(jnp.asarray, st)
    tst = params_from_jax(st, "cpu")
    jx, tx = _x(2, 3, seed=6)
    for t in range(3):
        jo, jst = jxlstm._mlstm_decode(jp, jx[:, t:t + 1], jcfg, jst)
        to, tst2 = txlstm._mlstm_decode(tp, tx[:, t:t + 1], tcfg, tst)
        ao, _ = txlstm.mlstm_apply(tp, tx[:, t:t + 1], cfg=tcfg,
                                   state=tst)
        _close(to, jo)
        _states(jst, tst2)
        assert torch.equal(ao, to)
        tst = tst2


def test_slstm_streaming_state_matches_jax():
    """5 + 7 tokens with the carried state against the JAX package
    streamed the same way, and against the whole sequence."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.slstm_shapes)
    jx, tx = _x(2, 12)
    jst = jtransformer._zero_state(jxlstm.slstm_state_shapes(jcfg, 2))
    tst = ttransformer._zero_state(txlstm.slstm_state_shapes(tcfg, 2),
                                   "cpu")
    outs = []
    for sl in (slice(0, 5), slice(5, 12)):
        jo, jst = jxlstm.slstm_apply(jp, jx[:, sl], cfg=jcfg, state=jst)
        to, tst = txlstm.slstm_apply(tp, tx[:, sl], cfg=tcfg, state=tst)
        _close(to, jo)
        _states(jst, tst)
        outs.append(to)
    full, none = txlstm.slstm_apply(tp, tx, cfg=tcfg)
    assert none is None
    _close(full, jxlstm.slstm_apply(jp, jx, cfg=jcfg)[0])
    _close(torch.cat(outs, 1), full.numpy(), rtol=1e-5, atol=1e-6)


def test_slstm_apply_from_a_state_matches_jax():
    """``slstm_apply`` from a nonzero state: a 6-token run and a decode
    step (T = 1), against the JAX package."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jxlstm.slstm_shapes, seed=3)
    st = _random_state(jxlstm.slstm_state_shapes(jcfg, 2), 7)
    for T in (6, 1):
        jx, tx = _x(2, T, seed=T)
        jo, jst = jxlstm.slstm_apply(jp, jx, cfg=jcfg,
                                     state=jax.tree.map(jnp.asarray, st))
        to, tst = txlstm.slstm_apply(tp, tx, cfg=tcfg,
                                     state=params_from_jax(st, "cpu"))
        _close(to, jo)
        _states(jst, tst)


def test_zero_state_sets_every_stabiliser_to_minus_1e30():
    """A zeroed xLSTM decode cache holds -1e30 in every leaf named ``m``
    (the mLSTM's and the sLSTM's stabilisers) and 0 elsewhere, as the
    JAX package's ``init_cache``; the shapes and types are its."""
    jcfg, tcfg = _cfgs()
    jcache = jtransformer.init_cache(jcfg, 2, 16)
    tcache = ttransformer.init_cache(tcfg, 2, 16, device="cpu")
    jflat = j_flatten(jcache)
    flat = tree_flatten_with_paths(tcache)
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    stabilisers = 0
    for (path, leaf), (_, want) in zip(flat, jflat):
        assert bool((leaf == (-1e30 if path.endswith("/m") else 0)).all()), \
            path
        stabilisers += path.endswith("/m")
        want = np.asarray(want)
        assert tuple(leaf.shape) == want.shape, path
        assert str(leaf.dtype).split(".")[1] == want.dtype.name, path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      want.astype(np.float32), err_msg=path)
    assert stabilisers == 8        # 7 mLSTM + 1 sLSTM positions
