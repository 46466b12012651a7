"""The port's encoder-decoder stack against the JAX package's, on the CPU.

The config is the reduced twin of ``seamless-m4t-large-v2``
(``cfg.reduced()``: 2 encoder and 2 decoder layers, d_model 64, 4 query
heads on 2 kv heads of 16, vocab 256).  Parameters are made by
``repro.models.model.init_params`` at a seed and carried across leaf for
leaf (``repro_torch.convert.params_from_jax``); tokens, labels and the
encoder frames are made from one numpy seed and fed to both packages.
The frames are longer than the prompt, so the cross-attention's queries
and keys differ in length.  The JAX package's encoder and cross-attention
run its ``scan`` lowering (its Pallas kernel is not on that route); the
port's run the ``flash_attention`` op, whose plain version is held here
to the Pallas kernel in interpret mode at the reduced shapes.

Tolerances: float32 modules within 1e-5 of the output's scale (sums in
another order); float32 logits, caches and every parameter's gradient
within 1e-4 of their scale (the stack compounds those differences); the
port's own prefill plus decode against its forward within 1e-4.
bfloat16: the two packages round at other places (XLA fuses elementwise
chains in float32; the port's plain attention keeps p in float32 where
the JAX ``scan`` rounds it), so the port's bf16 logits and gradients must
lie no farther (x2, plus 1e-3 of the scale for the logits) from the
float32 results of the same bf16-valued parameters than the JAX
package's bf16 results do (the loss: twice the JAX distance or 2**-8
of itself, whichever is larger).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.inputs as jinputs
from repro.configs import ARCHS, SHAPES
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import model as jmodel
from repro.parallel.sharding import NO_PARALLEL as J_NOP
from repro.parallel.sharding import ParallelConfig as JPC
from repro.utils.pytree import tree_flatten_with_paths as j_flatten
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import inputs as tinputs
from repro_torch.models import model as tmodel
from repro_torch.parallel.sharding import NO_PARALLEL as T_NOP
from repro_torch.parallel.sharding import ParallelConfig as TPC
from repro_torch.train import step as tstep
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map

NAME = "seamless-m4t-large-v2"
F32_TOL, LOGIT_TOL, GRAD_TOL, BF16_RATIO = 1e-5, 1e-4, 1e-4, 2.0
T, F = 20, 28                    # prompt tokens, encoder frames
_CACHE = {}


def _cfgs(dtype="float32"):
    j = ARCHS[NAME].reduced().replace(param_dtype=dtype, compute_dtype=dtype)
    t = tconfigs.get_config(NAME).reduced().replace(param_dtype=dtype,
                                                    compute_dtype=dtype)
    return j, t


def _params(dtype="float32"):
    """(JAX params, the port's copy), made once per dtype."""
    if dtype not in _CACHE:
        jcfg, _ = _cfgs(dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _CACHE[dtype] = jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu")
    return _CACHE[dtype]


def _batch(cfg, B=2, seed=0, n_tok=T, n_frames=F):
    """(JAX batch, the port's batch): tokens, next-token labels (the first
    5 of row 0 ignored) and float32 frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_tok + 1)).astype(np.int32)
    inputs, labels = toks[:, :-1].copy(), toks[:, 1:].copy()
    labels[0, :5] = -1
    frames = rng.standard_normal((B, n_frames, cfg.d_model)).astype(
        np.float32)
    host = {"inputs": inputs, "labels": labels, "enc_frames": frames}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    """Within ``tol`` of ``want``'s largest magnitude."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.abs(w).max(initial=0)), 1e-30)
    err = float(np.abs(g - w).max(initial=0))
    assert err <= tol * scale, (err, scale)


def _layer(tree, g=0):
    """Group ``g``'s slice of unit layer 0 (either package's tree)."""
    def cut(sub):
        return {k: cut(v) for k, v in sub.items()} if isinstance(sub, dict) \
            else sub[g]
    return cut(tree["blocks"]["layer0"])


# ------------------------------------------------------------ trees
def test_param_and_cache_trees_match_jax():
    """``init_params`` follows the JAX tree (the ``encoder`` stack, the
    decoder's ``norm_x`` / ``xattn``, the ``frontend`` projection) by
    path, shape and type; ``cache_shapes`` with ``cross_len`` adds the
    ``xk`` / ``xv`` leaves and without it none; ``params_from_jax`` /
    ``cache_from_jax`` carry every leaf bit for bit."""
    jcfg, tcfg = _cfgs("bfloat16")
    params = tmodel.init_params(tcfg, torch.Generator().manual_seed(3),
                                "cpu")
    jshapes = j_flatten(jmodel.param_shapes(jcfg))
    flat = tree_flatten_with_paths(params)
    assert [p for p, _ in flat] == [p for p, _ in jshapes]
    assert {"encoder/final_norm/scale", "frontend/w1",
            "blocks/layer0/xattn/wq", "blocks/layer0/norm_x/scale"} \
        <= {p for p, _ in flat}
    for (path, t), (_, spec) in zip(flat, jshapes):
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype).split(".")[1] == spec.dtype.name, path
    for cross in (0, 12):
        jc = j_flatten(jmodel.cache_shapes(jcfg, 2, 16, cross_len=cross))
        tc = tree_flatten_with_paths(tmodel.cache_shapes(tcfg, 2, 16,
                                                         cross_len=cross))
        assert [(p, tuple(s.shape), str(s.dtype).split(".")[1])
                for p, s in tc] == [(p, s.shape, s.dtype.name)
                                    for p, s in jc]
        assert any(p.endswith("xk") for p, _ in tc) == bool(cross)
    jp, tp = _params("bfloat16")
    jcache = jax.tree.map(lambda a: a + jnp.ones_like(a),
                          jmodel.init_cache(jcfg, 2, 16, cross_len=12))
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    for jtree, ttree in ((jp, tp), (jcache, tcache)):
        for (path, got), (_, want) in zip(tree_flatten_with_paths(ttree),
                                          j_flatten(jtree)):
            assert got.dtype == torch.bfloat16, path
            assert np.array_equal(_np(got), _np(want)), path


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_match_jax(name, shape):
    """``models/inputs.py``: each arch's train / prefill / decode batch
    stand-ins (the frontend's ``patch_embeds`` / ``patch_pos``, the
    encoder's ``enc_frames``) by path, shape and type."""
    want = j_flatten(jinputs.input_specs(ARCHS[name], SHAPES[shape]))
    got = tree_flatten_with_paths(tinputs.input_specs(
        tconfigs.get_config(name), tconfigs.SHAPES[shape]))
    assert [(p, tuple(s.shape), str(s.dtype).split(".")[1]) for p, s in got] \
        == [(p, s.shape, s.dtype.name) for p, s in want]


# ---------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_q,n_k", [(F, F), (T, F)])
def test_flash_op_matches_the_pallas_kernel_non_causal(dtype, n_q, n_k):
    """The encoder's (T = S) and the cross-attention's (T != S) route of
    the ``flash_attention`` op, non-causal, at the reduced heads, against
    the JAX package's Pallas kernel in interpret mode: within 2e-5
    (float32) / 2e-2 (bf16, the plain version keeps p in float32)."""
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(n_q * 100 + n_k)
    H, K, D = jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_head
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal(s), jdt))
               for s in ((2, n_q, H, D), (2, n_k, K, D), (2, n_k, K, D)))
    got = flash_attention(*(torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (q, k, v)), causal=False)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=False, window=0, interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_encoder_self_attention_matches_jax():
    """``mode="encode"``: non-causal self-attention with RoPE, no cache."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    x = np.random.default_rng(1).standard_normal(
        (2, F, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(F, dtype=np.int32), (2, F)).copy()
    ty, tc = tattn.apply(_layer(tp["encoder"])["attn"], torch.from_numpy(x),
                         cfg=tcfg, pcfg=T_NOP, layer_sym="A",
                         positions=torch.from_numpy(pos), mode="encode")
    jy, jc = jattn.apply(_layer(jp["encoder"])["attn"], jnp.asarray(x),
                         cfg=jcfg, pcfg=J_NOP, layer_sym="A",
                         positions=jnp.asarray(pos), mode="encode")
    assert tc is None and jc is None
    _close(ty, jy, F32_TOL)
    # the causal stack's prefill of the same layer differs: the mask moved
    causal, _ = tattn.apply(_layer(tp["encoder"])["attn"],
                            torch.from_numpy(x), cfg=tcfg, pcfg=T_NOP,
                            layer_sym="A", positions=torch.from_numpy(pos),
                            mode="train")
    assert float((causal - ty).abs().max()) > 1e-3


def test_cross_attention_prefill_and_decode_match_jax():
    """``memory_kv``: the decoder's cross block over a memory of F rows,
    at prefill (the flash op, queries and keys of different lengths) and
    at two decode steps over the same memory as a cache (every row
    live), with the cache passed through."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    jx, tx = _layer(jp)["xattn"], _layer(tp)["xattn"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, T, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, F, jcfg.d_model)).astype(np.float32)
    jkv = jattn._project_kv(jx, jnp.asarray(mem), jcfg)
    tkv = tattn._project_kv(tx, torch.from_numpy(mem), tcfg)
    for got, want in zip(tkv, jkv):
        _close(got, want, F32_TOL)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    ty, tc = tattn.apply(tx, torch.from_numpy(x), cfg=tcfg, pcfg=T_NOP,
                         layer_sym="A", positions=torch.from_numpy(pos),
                         mode="prefill", memory_kv=tkv)
    jy, _ = jattn.apply(jx, jnp.asarray(x), cfg=jcfg, pcfg=J_NOP,
                        layer_sym="A", positions=jnp.asarray(pos),
                        mode="prefill", memory_kv=jkv)
    assert tc is None
    _close(ty, jy, F32_TOL)
    marker = {"k": torch.zeros(1)}
    for step in range(2):
        xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        p = np.full((2, 1), T + step, np.int32)
        ty, tc = tattn.apply(tx, torch.from_numpy(xd), cfg=tcfg, pcfg=T_NOP,
                             layer_sym="A", positions=torch.from_numpy(p),
                             mode="decode", cache=marker, memory_kv=tkv)
        jy, _ = jattn.apply(jx, jnp.asarray(xd), cfg=jcfg, pcfg=J_NOP,
                            layer_sym="A", positions=jnp.asarray(p),
                            mode="decode", cache=None, memory_kv=jkv)
        assert tc is marker
        _close(ty, jy, F32_TOL)


# ------------------------------------------------------------ model
def test_forward_matches_jax_float32():
    """The full forward (frames through the projection, the encoder and
    its norm; the decoder's cross blocks over the memory): logits and aux
    within 1e-4 of the scale; the memory itself within 1e-5."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    jb, tb = _batch(jcfg)
    jl, jaux = jmodel.forward(jp, jb, cfg=jcfg)
    with torch.inference_mode():
        tl, taux = tmodel.forward(tp, tb, cfg=tcfg)
        tmem = tmodel._encode(tp, tb["enc_frames"], cfg=tcfg, pcfg=T_NOP)
    jmem = jmodel._encode(jp, jb["enc_frames"], cfg=jcfg, pcfg=J_NOP)
    _close(tmem, jmem, F32_TOL)
    _close(tl, jl, LOGIT_TOL)
    assert float(taux) == float(jaux) == 0.0


def _jax_grads(dtype, fused):
    key = ("grads", dtype, fused)
    if key not in _CACHE:
        jcfg, _ = _cfgs(dtype)
        jp, _ = _params(dtype)
        jb, _ = _batch(jcfg)
        pcfg = JPC(mesh=None, remat="none", fused_head=fused, head_chunk=16)
        _CACHE[key] = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb, cfg=jcfg, pcfg=pcfg),
            has_aux=True))(jp)
    return _CACHE[key]


def _port_grads(params, cfg, fused, remat="full"):
    _, tb = _batch(cfg)
    pcfg = TPC(mesh=None, remat=remat, fused_head=fused, head_chunk=16)
    return tstep._value_and_grad_accum(params, tb, cfg=cfg, pcfg=pcfg)


@pytest.mark.parametrize("fused", [True, False])
def test_loss_fn_and_grads_match_jax_float32(fused):
    """``loss_fn`` (the fused head in chunks of 16 of the 40 tokens, or
    materialised logits), its metrics, and every parameter's gradient
    (the encoder's, the cross blocks' and the frame projection's among
    them) with full remat in the port: within 1e-4 of each leaf's
    scale."""
    (jl, jm), jg = _jax_grads("float32", fused)
    _, tcfg = _cfgs()
    _, tp = _params()
    (tl, tm), tg = _port_grads(tp, tcfg, fused)
    _close(tl, jl, F32_TOL)
    for k in jm:
        _close(tm[k], jm[k], F32_TOL)
    jflat = j_flatten(jg)
    tflat = tree_flatten_with_paths(tg)
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    assert float(np.abs(_np(tg["frontend"]["w1"])).max()) > 0
    for (path, got), (_, want) in zip(tflat, jflat):
        _close(got, want, GRAD_TOL)


def test_loss_fn_grads_bf16_as_close_to_float32_as_jax():
    """bf16 parameters: each leaf's gradient lies no farther (x2) from
    the float32 gradient of the same bf16-valued parameters than the JAX
    package's bf16 gradient does; the loss no farther than twice the JAX
    package's distance or 2**-8 of itself, whichever is larger (one
    number, read from bf16 logits that each carry a rounding of 2**-9;
    here the JAX bf16 loss lies 0.034 from the float32 one, the port's
    0.010)."""
    (jl, _), jg = _jax_grads("bfloat16", True)
    _, tcfg = _cfgs("bfloat16")
    _, tp = _params("bfloat16")
    (tl, _), tg = _port_grads(tp, tcfg, True)
    cfg32 = tcfg.replace(param_dtype="float32", compute_dtype="float32")
    (l32, _), g32 = _port_grads(tree_map(lambda x: x.float(), tp), cfg32,
                                True, remat="none")
    assert abs(float(tl) - float(l32)) <= max(
        BF16_RATIO * abs(float(jl) - float(l32)), 2 ** -8 * float(l32))
    for (path, truth), (_, jgot), (_, tgot) in zip(
            tree_flatten_with_paths(g32), j_flatten(jg),
            tree_flatten_with_paths(tg)):
        assert tgot.dtype == torch.bfloat16, path
        t = truth.double().numpy()
        ej = np.linalg.norm(np.asarray(jgot, np.float64) - t)
        ep = np.linalg.norm(tgot.double().numpy() - t)
        assert ep <= BF16_RATIO * ej + 1e-6 * np.linalg.norm(t), \
            (path, ep, ej)


def _cache_leaves_match(tcache, jcache, tol):
    jflat = j_flatten(jcache)
    tflat = tree_flatten_with_paths(tcache)
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (path, got), (_, want) in zip(tflat, jflat):
        assert tuple(got.shape) == np.asarray(want).shape, path
        _close(got, want, tol)


def test_prefill_and_decode_match_jax_float32():
    """``prefill`` (the encoder, then the decoder over the prompt with the
    memory's cross K / V stored as ``xk`` / ``xv``): last logits and every
    cache leaf; then three decode steps, each from the JAX package's own
    cache carried across, attending the cached cross K / V."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    jb, tb = _batch(jcfg, seed=4)
    max_len = 32
    jb.pop("labels"), tb.pop("labels")
    jl, jc = jmodel.prefill(jp, jb, cfg=jcfg, max_len=max_len)
    with torch.inference_mode():
        tl, tc = tmodel.prefill(tp, tb, cfg=tcfg, max_len=max_len)
    _close(tl, jl, LOGIT_TOL)
    _cache_leaves_match(tc, jc, LOGIT_TOL)
    assert tuple(tc["layer0"]["xk"].shape) == (
        jcfg.n_groups, 2, F, jcfg.n_kv_heads, jcfg.d_head)
    rng = np.random.default_rng(5)
    for step in range(3):
        tc = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), T + step, np.int32)
        jl, jc = jmodel.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), cfg=jcfg)
        with torch.inference_mode():
            tl, tc = tmodel.decode_step(tp, tc, torch.from_numpy(tok),
                                        torch.from_numpy(pos), cfg=tcfg)
        _close(tl, jl, LOGIT_TOL)
        _cache_leaves_match(tc, jc, LOGIT_TOL)


def test_decode_continues_the_forward():
    """The JAX package's consistency check on the port (float32): a
    prefill of T - 1 tokens and one decode step over the cached cross
    K / V give the full forward's last two logit rows within 1e-4 of
    their scale."""
    _, tcfg = _cfgs()
    _, tp = _params()
    _, tb = _batch(tcfg, seed=6)
    toks = tb["inputs"]
    with torch.inference_mode():
        full, _ = tmodel.forward(tp, tb, cfg=tcfg)
        last, cache = tmodel.prefill(
            tp, {"inputs": toks[:, :T - 1], "enc_frames": tb["enc_frames"]},
            cfg=tcfg, max_len=T + 4)
        dec, _ = tmodel.decode_step(tp, cache, toks[:, T - 1:],
                                    torch.full((2,), T - 1,
                                               dtype=torch.int32), cfg=tcfg)
    _close(last, full[:, T - 2], LOGIT_TOL)
    _close(dec, full[:, T - 1], LOGIT_TOL)


def test_bf16_logits_as_close_to_float32_as_jax():
    """bf16: the forward's logits, prefill's last logits and a decode
    step's lie no farther (x2, plus 1e-3 of the scale) from the float32
    logits of the same bf16-valued parameters than the JAX package's
    bf16 logits do."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params("bfloat16")
    cfg32 = tcfg.replace(param_dtype="float32", compute_dtype="float32")
    tp32 = tree_map(lambda a: a.float(), tp)
    jb, tb = _batch(jcfg, seed=7)
    jb.pop("labels"), tb.pop("labels")
    tok = np.full((2, 1), 9, np.int32)
    pos = np.full((2,), T, np.int32)
    jf, _ = jmodel.forward(jp, jb, cfg=jcfg)
    jl, jc = jmodel.prefill(jp, jb, cfg=jcfg, max_len=T + 4)
    jd, _ = jmodel.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                               cfg=jcfg)
    got, want = [], []
    with torch.inference_mode():
        for p, cfg, out in ((tp, tcfg, got), (tp32, cfg32, want)):
            fw, _ = tmodel.forward(p, tb, cfg=cfg)
            lg, c = tmodel.prefill(p, tb, cfg=cfg, max_len=T + 4)
            dl, _ = tmodel.decode_step(p, c, torch.from_numpy(tok),
                                       torch.from_numpy(pos), cfg=cfg)
            out += [fw, lg, dl]
    for g, j, w in zip(got, (jf, jl, jd), want):
        w = _np(w).astype(np.float64)
        ej = np.abs(_np(j) - w).max()
        ep = np.abs(_np(g) - w).max()
        assert ep <= 2 * ej + 1e-3 * np.abs(w).max(), (ep, ej)
