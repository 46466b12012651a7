"""The port's LM modules against the JAX package's, on the CPU.

Parameters are made by ``repro.models.model.init_params`` at a seed and
carried across leaf for leaf (``repro_torch.convert.params_from_jax``);
other inputs are made from one numpy seed and fed to both packages.  The
configs are the reduced twins (``cfg.reduced()``: d_model 64, window 64,
vocab 256) of ``recurrentgemma-2b`` (R and L layers) and ``qwen2.5-3b``
(A layers), then of the xLSTM and MoE families and of the four configs
held last (``SHIPPED``: ``gemma3-12b``'s 5:1 local / global unit with its
own local RoPE theta, qk-norm, GeGLU and tied, scaled embeddings;
``qwen3-8b``; ``deepseek-7b``; ``dbrx-132b``'s 16 experts, top-4).
``reduced()`` drops two of their features (it caps ``n_kv_heads`` at 2
and sets ``d_head`` to ``d_model / n_heads``), so two variants put them
back by ``replace()`` in both packages alike (``tests/torch_held.py``):
``deepseek-7b:mha`` (4 / 4 heads) and ``gemma3-12b:d_head32`` (``d_head``
32 at ``d_model`` 64 and 4 heads).

Tolerances: float32 modules within 1e-5 (the sums run in another order);
float32 logits within 1e-4 of the logits' scale (the largest |logit|);
bfloat16 logits within 6e-2 of that scale: the two packages round bf16
at other places (XLA fuses elementwise chains in float32, torch rounds
each op; the port's attention keeps p in float32 as the TPU kernel
does, where the JAX scan rounds it), and 26 layers of bf16 residuals
carry those one-ulp differences to about 2-4% of the scale.  That bar
holds ``recurrentgemma-2b`` and ``qwen2.5-3b``; the JAX package's own
bf16 logits of ``gemma3-12b`` lie 0.07 of the scale from its float32
ones, so every config's bf16 logits and caches are also held no farther
(x2, plus 1e-3 of the scale) from the float32 ones of the same
bf16-valued parameters than the JAX package's bf16 ones are.  Integer
leaves (the ring ``kpos``) match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.common as jcommon
import repro.models.mlp as jmlp
import repro.models.rglru as jrglru
from repro.configs import ARCHS
from repro.models import model as jmodel
from repro.parallel.sharding import NO_PARALLEL as J_NOP
from repro.utils.pytree import tree_flatten_with_paths as j_flatten
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.parallel.sharding import NO_PARALLEL as T_NOP
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map
from torch_held import HELD, reduced

F32_TOL = 1e-5
BF16_RATIO = 2.0
_CACHE = {}


def _cfgs(name, dtype="float32"):
    """(JAX config, the port's): ``name``'s reduced twin in ``dtype``, or
    a variant ``"<arch>:<tag>"`` of it (``tests/torch_held.py``)."""
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    return (reduced(ARCHS.__getitem__, name, **kw),
            reduced(tconfigs.get_config, name, **kw))


def _params(name, dtype="float32"):
    """(JAX params, the port's copy), made once per config."""
    if (name, dtype) not in _CACHE:
        jcfg, _ = _cfgs(name, dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _CACHE[name, dtype] = jp, params_from_jax(jax.tree.map(np.asarray,
                                                               jp), "cpu")
    return _CACHE[name, dtype]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32) if x.dtype != np.int32 \
        else np.asarray(x)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _layer(tree, i, g=0):
    """Group ``g``'s slice of unit layer ``i`` (either package's tree)."""
    return _slice(tree["blocks"][f"layer{i}"], g)


def _slice(tree, g):
    if isinstance(tree, dict):
        return {k: _slice(v, g) for k, v in tree.items()}
    return tree[g]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ primitives
def test_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 7, 3, 16)
    scale = _rand(rng, 16)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            1e-6),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           1e-4)                         # angles up to 5000 rad
    for name in ("silu", "gelu"):
        _close(tcommon.activation(name)(torch.from_numpy(x)),
               jcommon.activation(name)(jnp.asarray(x)))
    _close(tcommon.soft_cap(torch.from_numpy(x), 2.0),
           jcommon.soft_cap(jnp.asarray(x), 2.0))
    xs, w, st = _rand(rng, 2, 9, 12), _rand(rng, 4, 12), _rand(rng, 2, 3, 12)
    _close(tcommon.causal_conv1d(torch.from_numpy(xs), torch.from_numpy(w)),
           jcommon.causal_conv1d(jnp.asarray(xs), jnp.asarray(w)))
    ty, tst = tcommon.causal_conv1d(torch.from_numpy(xs), torch.from_numpy(w),
                                    torch.from_numpy(st))
    jy, jst = jcommon.causal_conv1d(jnp.asarray(xs), jnp.asarray(w),
                                    jnp.asarray(st))
    _close(ty, jy)
    _close(tst, jst)
    bw = _rand(rng, 4, 3, 5)
    _close(tcommon.block_diag_apply({"w": torch.from_numpy(bw)},
                                    torch.from_numpy(xs)),
           jcommon.block_diag_apply({"w": jnp.asarray(bw)}, jnp.asarray(xs)))
    assert tcommon.round_up(65, 64) == jcommon.round_up(65, 64) == 128


def test_init_params_follows_the_jax_rules():
    jcfg, tcfg = _cfgs("recurrentgemma-2b", "bfloat16")
    jshapes = j_flatten(jmodel.param_shapes(jcfg))
    gen = torch.Generator().manual_seed(3)
    params = tmodel.init_params(tcfg, gen, "cpu")
    flat = tree_flatten_with_paths(params)
    assert [p for p, _ in flat] == [p for p, _ in jshapes]
    for (path, t), (_, spec) in zip(flat, jshapes):
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype).split(".")[1] == spec.dtype.name, path
        name = path.rsplit("/", 1)[-1]
        if name == "scale":
            assert bool((t == 1).all()), path
        elif name == "a_param":
            a = torch.exp(-8.0 * torch.nn.functional.softplus(t))
            assert 0.89 < float(a.min()) and float(a.max()) < 0.9991, path
        else:
            std = float(t.float().std())
            assert 0.5 < std * np.sqrt(spec.shape[-2]) < 1.5, path
    again = tmodel.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flat, tree_flatten_with_paths(again)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["gemma3-12b", "recurrentgemma-2b"])
def test_embed_scale_rounds_as_jax(name, dtype):
    """The scaled embedding at the full config's width (``d_model`` 3840:
    sqrt is 61.97, 62 in bf16; 2560: 50.596, 50.5): gathered, cast to
    the compute type, times sqrt(d_model) rounded to that type first, as
    the JAX package orders it, bit for bit.  The reduced configs'
    ``d_model`` of 64 has an exact root, so only this width shows the
    order."""
    from repro.models import transformer as jtransformer
    from repro_torch.models import transformer as ttransformer
    kw = {"vocab_size": 64, "param_dtype": dtype, "compute_dtype": dtype}
    jcfg = ARCHS[name].replace(**kw)
    tcfg = tconfigs.get_config(name).replace(**kw)
    rng = np.random.default_rng(9)
    w = jnp.asarray(rng.standard_normal((64, jcfg.d_model)), dtype)
    toks = rng.integers(0, 64, (2, 7)).astype(np.int32)
    want = jtransformer.embed({"embed": {"w": w}}, jnp.asarray(toks),
                              cfg=jcfg, pcfg=J_NOP)
    tw = params_from_jax({"embed": {"w": np.asarray(w)}}, "cpu")
    got = ttransformer.embed(tw, torch.from_numpy(toks), cfg=tcfg,
                             pcfg=T_NOP)
    assert str(got.dtype).split(".")[1] == dtype
    assert np.array_equal(_np(got), _np(want))


# --------------------------------------------------------------- modules
def test_mlp_matches_jax():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params("recurrentgemma-2b")
    x = _rand(np.random.default_rng(1), 2, 5, jcfg.d_model)
    _close(tmlp.apply(_layer(tp, 0)["mlp"], torch.from_numpy(x), cfg=tcfg,
                      pcfg=T_NOP),
           jmlp.apply(_layer(jp, 0)["mlp"], jnp.asarray(x), cfg=jcfg,
                      pcfg=J_NOP))


def test_rglru_whole_and_streamed_match_jax():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params("recurrentgemma-2b")
    jl, tl = _layer(jp, 0)["rglru"], _layer(tp, 0)["rglru"]
    x = _rand(np.random.default_rng(2), 2, 20, jcfg.d_model)
    ty, _ = trglru.apply(tl, torch.from_numpy(x), cfg=tcfg)
    jy, _ = jrglru.apply(jl, jnp.asarray(x), cfg=jcfg)
    _close(ty, jy)
    # streamed in two halves with the carried state, against the JAX
    # package streamed the same way
    w = jcfg.lru_width
    st_t = {"h": torch.zeros(2, w), "conv": torch.zeros(2, 3, w)}
    st_j = {"h": jnp.zeros((2, w)), "conv": jnp.zeros((2, 3, w))}
    outs = []
    for half in (x[:, :9], x[:, 9:]):
        ty, st_t = trglru.apply(tl, torch.from_numpy(half), cfg=tcfg,
                                state=st_t)
        jy, st_j = jrglru.apply(jl, jnp.asarray(half), cfg=jcfg, state=st_j)
        _close(ty, jy)
        outs.append(ty)
    _close(st_t["h"], st_j["h"])
    _close(st_t["conv"], st_j["conv"])
    _close(torch.cat(outs, 1), trglru.apply(tl, torch.from_numpy(x),
                                            cfg=tcfg)[0])


@pytest.mark.parametrize("name,sym,S", [
    ("qwen2.5-3b", "A", 40), ("recurrentgemma-2b", "L", 100),
    ("gemma3-12b", "L", 100), ("gemma3-12b", "A", 40),
    ("gemma3-12b:d_head32", "L", 100), ("gemma3-12b:d_head32", "A", 40),
    ("deepseek-7b:mha", "A", 40)])
def test_attention_prefill_and_decode_match_jax(name, sym, S):
    """Prefill (an A layer; an L layer with a prompt longer than the
    window of 64) and then two decode steps against the full or ring
    cache it built.  ``gemma3-12b``'s L layers rotate by their own
    ``rope_theta_local`` (1e4, its A layers by 1e6) at prefill and in
    decode, and normalise q and k per head."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    i = list(jcfg.block_pattern).index(sym)
    ja, ta = _layer(jp, i)["attn"], _layer(tp, i)["attn"]
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, S, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    max_len = 128
    ty, tc = tattn.apply(ta, torch.from_numpy(x), cfg=tcfg, pcfg=T_NOP,
                         layer_sym=sym, positions=torch.from_numpy(pos),
                         mode="prefill", max_len=max_len)
    jy, jc = jattn.apply(ja, jnp.asarray(x), cfg=jcfg, pcfg=J_NOP,
                         layer_sym=sym, positions=jnp.asarray(pos),
                         mode="prefill", max_len=max_len)
    _close(ty, jy)
    assert sorted(tc) == sorted(jc)
    assert ("kpos" in tc) == (sym == "L")
    for key in tc:
        if key == "kpos":
            assert np.array_equal(tc[key].numpy(), np.asarray(jc[key]))
        else:
            _close(tc[key], jc[key])
    for step in range(2):
        xd = _rand(rng, 2, 1, jcfg.d_model)
        p = np.full((2, 1), S + step, np.int32)
        for mode in ("masked", "scatter"):
            ty, tc2 = tattn.apply(
                ta, torch.from_numpy(xd), cfg=tcfg,
                pcfg=T_NOP.with_(cache_write=mode), layer_sym=sym,
                positions=torch.from_numpy(p), mode="decode", cache=tc)
            jy, jc2 = jattn.apply(
                ja, jnp.asarray(xd), cfg=jcfg,
                pcfg=J_NOP.with_(cache_write=mode), layer_sym=sym,
                positions=jnp.asarray(p), mode="decode", cache=jc)
            _close(ty, jy)
            for key in tc2:
                _close(tc2[key], jc2[key])
        tc, jc = tc2, jc2


def _cache_leaves_match(tcache, jcache, tol):
    jflat = dict(j_flatten(jcache))
    tflat = tree_flatten_with_paths(tcache)
    assert [p for p, _ in tflat] == sorted(jflat)
    for path, leaf in tflat:
        want = np.asarray(jflat[path])
        assert tuple(leaf.shape) == want.shape, path
        if path.endswith("kpos"):
            assert np.array_equal(leaf.numpy(), want), path
        else:
            scale = max(1.0, float(np.abs(_np(want)).max()))
            np.testing.assert_allclose(_np(leaf), _np(want), rtol=0,
                                       atol=tol * scale, err_msg=path)


def _bf16_as_close_to_f32_as_jax(got, want, truth, path=""):
    """``got`` (the port's bf16) no farther from ``truth`` (the port's
    float32 run of the same bf16-valued parameters) than twice the JAX
    package's bf16 ``want`` is, plus 1e-3 of the truth's norm; distances
    in norm over the whole array, as the bf16 gradients are held in
    ``test_torch_train.py``.  (Both packages' bf16 caches of reduced
    ``gemma3-12b`` lie 0.3-10% of their norm from float32, the port's
    within 10% of the JAX package's distance at every leaf; the largest
    single element of a decode step's one written row is noisier, and
    reads up to 2.1x.)"""
    t = _np(truth).astype(np.float64)
    ej = float(np.linalg.norm(_np(want) - t))
    ep = float(np.linalg.norm(_np(got) - t))
    assert ep <= BF16_RATIO * ej + 1e-3 * float(np.linalg.norm(t)), \
        (path, ep, ej)


def _bf16_caches_as_close_to_f32_as_jax(tcache, jcache, truth):
    jflat = j_flatten(jcache)
    for (path, got), (_, want), (_, t) in zip(
            tree_flatten_with_paths(tcache), jflat,
            tree_flatten_with_paths(truth)):
        if path.endswith("kpos"):
            assert np.array_equal(got.numpy(), np.asarray(want)), path
        else:
            _bf16_as_close_to_f32_as_jax(got, want, t, path)


def _f32(cfg, params):
    """``cfg`` and ``params`` (bf16) as float32: the same values."""
    return (cfg.replace(param_dtype="float32", compute_dtype="float32"),
            tree_map(lambda a: a.float(), params))


def _f32_cache(cache):
    return tree_map(lambda a: a if a.dtype == torch.int32 else a.float(),
                    cache)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "qwen2.5-3b"] + HELD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(name, dtype):
    """model.prefill over a prompt longer than the window, then three
    decode steps; logits and caches against the JAX package's.  In bf16
    ``recurrentgemma-2b`` and ``qwen2.5-3b`` are held within 6e-2 of the
    scale, and every config no farther from the float32 run of the same
    bf16-valued parameters than the JAX package is (x2)."""
    jcfg, tcfg = _cfgs(name, dtype)
    jp, tp = _params(name, dtype)
    bf16 = dtype == "bfloat16"
    tol = 6e-2 if bf16 else 1e-4
    direct = not bf16 or name in ("recurrentgemma-2b", "qwen2.5-3b")
    cfg32, tp32 = _f32(tcfg, tp)
    rng = np.random.default_rng(4)
    S, max_len = 100, 128
    toks = rng.integers(0, jcfg.vocab_size, (1, S)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, {"inputs": jnp.asarray(toks)}, cfg=jcfg,
                            max_len=max_len)
    with torch.inference_mode():
        tl, tc = tmodel.prefill(tp, {"inputs": torch.from_numpy(toks)},
                                cfg=tcfg, max_len=max_len)
        if bf16:
            l32, c32 = tmodel.prefill(tp32, {"inputs": torch.from_numpy(
                toks)}, cfg=cfg32, max_len=max_len)
            _bf16_as_close_to_f32_as_jax(tl, jl, l32)
            _bf16_caches_as_close_to_f32_as_jax(tc, jc, c32)
    if direct:
        scale = float(np.abs(_np(jl)).max())
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=tol * scale)
        _cache_leaves_match(tc, jc, tol)
    # decode from the JAX package's own cache, carried across, so each
    # step compares one step of both packages on identical state
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (1, 1)).astype(np.int32)
        pos = np.array([S + step], np.int32)
        jl2, jc2 = jmodel.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(pos), cfg=jcfg)
        with torch.inference_mode():
            tl, tc2 = tmodel.decode_step(tp, tc, torch.from_numpy(tok),
                                         torch.from_numpy(pos), cfg=tcfg)
            if bf16:
                l32, c32 = tmodel.decode_step(
                    tp32, _f32_cache(tc), torch.from_numpy(tok),
                    torch.from_numpy(pos), cfg=cfg32)
                _bf16_as_close_to_f32_as_jax(tl, jl2, l32)
                _bf16_caches_as_close_to_f32_as_jax(tc2, jc2, c32)
        if direct:
            scale = float(np.abs(_np(jl2)).max())
            np.testing.assert_allclose(_np(tl), _np(jl2), rtol=0,
                                       atol=tol * scale)
            _cache_leaves_match(tc2, jc2, tol)
        jc = jc2
        tc = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")


@pytest.mark.parametrize("name", HELD)
def test_forward_matches_jax_and_prefill(name):
    """Float32: the training-mode forward's logits and aux loss against
    the JAX package's forward within 1e-4 of the logits' scale (1e-6 for
    the aux), and its last row equal to prefill's within 1e-5."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 30)).astype(np.int32)
    jl, jaux = jmodel.forward(jp, {"inputs": jnp.asarray(toks)}, cfg=jcfg)
    with torch.inference_mode():
        logits, aux = tmodel.forward(tp, {"inputs": torch.from_numpy(toks)},
                                     cfg=tcfg)
        last, _ = tmodel.prefill(tp, {"inputs": torch.from_numpy(toks)},
                                 cfg=tcfg)
    scale = float(np.abs(_np(jl)).max())
    np.testing.assert_allclose(_np(logits), _np(jl), rtol=0,
                               atol=1e-4 * scale)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0) == (tcfg.family == "moe")
    torch.testing.assert_close(logits[:, -1], last, rtol=0, atol=1e-5)


def test_forward_matches_prefill_logits():
    """The training-mode forward's last logits are prefill's."""
    _, tcfg = _cfgs("recurrentgemma-2b")
    _, tp = _params("recurrentgemma-2b")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 30)).astype(np.int32))
    with torch.inference_mode():
        logits, aux = tmodel.forward(tp, {"inputs": toks}, cfg=tcfg)
        last, _ = tmodel.prefill(tp, {"inputs": toks}, cfg=tcfg)
    assert float(aux) == 0.0
    torch.testing.assert_close(logits[:, -1], last, rtol=0, atol=1e-5)


def test_mesh_raises_and_default_device_is_cuda(monkeypatch):
    with pytest.raises(TypeError, match="Mesh"):
        ParallelConfig(mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        T_NOP.with_(mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_cache(tcfg, 1, 16)


@pytest.mark.parametrize("which", ["attention", "transformer"])
def test_init_cache_without_a_device_is_cuda(monkeypatch, which):
    """``attention.init_cache`` and ``transformer.init_cache`` resolve a
    missing device to CUDA, as ``model.init_cache`` does: without CUDA
    they raise, and ``device="cpu"`` still gives a CPU cache."""
    from repro_torch.models import transformer as ttransformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("recurrentgemma-2b")
    if which == "attention":
        make = lambda **kw: tattn.init_cache(tcfg, 1, 16, ring=True,  # noqa: E731
                                             window=8, **kw)
    else:
        make = lambda **kw: ttransformer.init_cache(tcfg, 1, 16, **kw)  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    leaves = tree_flatten_with_paths(make(device="cpu"))
    assert leaves and all(v.device.type == "cpu" for _, v in leaves)


# ------------------------------------------ the xLSTM and MoE families
NEW_FAMILIES = ["xlstm-1.3b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("name", NEW_FAMILIES + HELD)
def test_init_params_of_the_new_families_follow_the_jax_rules(name):
    """Paths, shapes and types of the JAX tree; norms 1, biases and gate
    biases 0, every other leaf fan-in scaled (the float32 gate weights
    and router too), drawn a block of the leading axis at a time."""
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jshapes = j_flatten(jmodel.param_shapes(jcfg))
    params = tmodel.init_params(tcfg, torch.Generator().manual_seed(3),
                                "cpu")
    flat = tree_flatten_with_paths(params)
    assert [p for p, _ in flat] == [p for p, _ in jshapes]
    for (path, t), (_, spec) in zip(flat, jshapes):
        assert tuple(t.shape) == spec.shape, path
        assert str(t.dtype).split(".")[1] == spec.dtype.name, path
        name_ = path.rsplit("/", 1)[-1]
        if name_ == "scale" or name_.endswith("_norm"):
            assert bool((t == 1).all()), path
        elif name_.startswith("b"):
            assert bool((t == 0).all()), path
        else:
            std = float(t.float().std())
            assert 0.5 < std * np.sqrt(spec.shape[-2]) < 1.5, path


def _one_ulp(jp):
    """The JAX parameters with every embedding entry moved by one float32
    ulp (a sign drawn from a seed)."""
    e = np.asarray(jp["embed"]["w"])
    sign = np.random.default_rng(0).choice([-1.0, 1.0], e.shape)
    return dict(jp, embed={"w": jnp.asarray(
        (e * (1 + 2.0 ** -23 * sign)).astype(np.float32))})


def _within_jax_spread(got, want, want_ulp, path=""):
    """``got`` within 1e-4 of ``want``'s scale plus twice the distance
    the JAX package itself moves when its embeddings move by one ulp."""
    w = _np(want).astype(np.float64)
    spread = float(np.abs(_np(want_ulp) - w).max(initial=0))
    bound = 1e-4 * max(1.0, float(np.abs(w).max(initial=0))) + 2 * spread
    err = float(np.abs(_np(got) - w).max(initial=0))
    assert err <= bound, (path, err, bound, spread)


def _caches_within_jax_spread(tcache, jcache, jcache_ulp):
    jflat, uflat = j_flatten(jcache), j_flatten(jcache_ulp)
    tflat = tree_flatten_with_paths(tcache)
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (path, got), (_, want), (_, ulp) in zip(tflat, jflat, uflat):
        assert tuple(got.shape) == np.asarray(want).shape, path
        _within_jax_spread(got, want, ulp, path)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_match_jax_float32(name):
    """Float32: the forward's logits and aux, prefill's last logits and
    cache, then three decode steps (each from the JAX package's own
    cache, carried across) against the JAX package, within 1e-4 of the
    scale plus twice the JAX package's own spread: what its outputs move
    when its embedding table moves by one ulp.  The MoE stack is well
    conditioned (its spread is far under 1e-4); the reduced xLSTM stack
    at random weights is not: a one-ulp change moves the JAX package's
    own logits by 1.0e-3 to 1.5e-3 of their scale through its 16 layers
    (the mLSTM divides by ``max(|q n|, exp(-m))``), and the port lies
    about half that far from it."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(name)
    jp_ulp = _one_ulp(jp)
    rng = np.random.default_rng(6)
    S, max_len = 20, 32
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    batch = {"inputs": jnp.asarray(toks)}
    (jl, jaux), (ul, _) = (jmodel.forward(p, batch, cfg=jcfg)
                           for p in (jp, jp_ulp))
    with torch.inference_mode():
        tl, taux = tmodel.forward(tp, {"inputs": torch.from_numpy(toks)},
                                  cfg=tcfg)
    _within_jax_spread(tl, jl, ul)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    assert (float(taux) > 0) == (name == "qwen3-moe-30b-a3b")
    (jl, jc), (ul, uc) = (jmodel.prefill(p, batch, cfg=jcfg,
                                         max_len=max_len)
                          for p in (jp, jp_ulp))
    with torch.inference_mode():
        tl, tc = tmodel.prefill(tp, {"inputs": torch.from_numpy(toks)},
                                cfg=tcfg, max_len=max_len)
    _within_jax_spread(tl, jl, ul)
    _caches_within_jax_spread(tc, jc, uc)
    for step in range(3):
        tc = cache_from_jax(jax.tree.map(np.asarray, jc), "cpu")
        tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full((2,), S + step, np.int32)
        ul, uc = jmodel.decode_step(jp_ulp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), cfg=jcfg)
        jl, jc = jmodel.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), cfg=jcfg)
        with torch.inference_mode():
            tl, tc = tmodel.decode_step(tp, tc, torch.from_numpy(tok),
                                        torch.from_numpy(pos), cfg=tcfg)
        _within_jax_spread(tl, jl, ul)
        _caches_within_jax_spread(tc, jc, uc)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_bf16_as_close_to_float32_as_jax(name):
    """bf16: prefill's last logits and a decode step's logits are no
    farther (x2, plus 1e-3 of the scale) from the float32 logits of the
    same bf16-valued parameters than the JAX package's bf16 logits are
    (the float32 logits are the port's, held to the JAX package's
    above)."""
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jp, tp = _params(name, "bfloat16")
    cfg32 = tcfg.replace(param_dtype="float32", compute_dtype="float32")
    tp32 = tree_map(lambda a: a.float(), tp)
    rng = np.random.default_rng(7)
    S = 20
    toks = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.full((2,), S, np.int32)
    jl, jc = jmodel.prefill(jp, {"inputs": jnp.asarray(toks)}, cfg=jcfg,
                            max_len=S + 4)
    jd, _ = jmodel.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                               cfg=jcfg)
    got, want = [], []
    with torch.inference_mode():
        for p, cfg, out in ((tp, tcfg, got), (tp32, cfg32, want)):
            lg, c = tmodel.prefill(p, {"inputs": torch.from_numpy(toks)},
                                   cfg=cfg, max_len=S + 4)
            dl, _ = tmodel.decode_step(p, c, torch.from_numpy(tok),
                                       torch.from_numpy(pos), cfg=cfg)
            out += [lg, dl]
    for g, j, w in zip(got, (jl, jd), want):
        w = _np(w).astype(np.float64)
        ej = np.abs(_np(j) - w).max()
        ep = np.abs(_np(g) - w).max()
        assert ep <= 2 * ej + 1e-3 * np.abs(w).max(), (ep, ej)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_decode_continues_the_forward(name, monkeypatch):
    """The JAX package's consistency check on the port: prefill of 11
    tokens and one decode step match the full forward's last two logit
    rows within 0.02 and 0.05 of their scale (float32; MoE at a no-drop
    capacity factor, since drops depend on the batch's composition)."""
    from repro_torch.models import moe as tmoe
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", 8.0)
    _, tcfg = _cfgs(name)
    _, tp = _params(name)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tmodel.forward(tp, {"inputs": toks}, cfg=tcfg)
        last, cache = tmodel.prefill(tp, {"inputs": toks[:, :S - 1]},
                                     cfg=tcfg, max_len=S + 4)
        dec, _ = tmodel.decode_step(tp, cache, toks[:, S - 1:],
                                    torch.full((B,), S - 1,
                                               dtype=torch.int32), cfg=tcfg)
    for got, want, tol in ((last, full[:, S - 2], 0.02),
                           (dec, full[:, S - 1], 0.05)):
        assert float((got - want).abs().max()) \
            < tol * float(want.abs().max())


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_params_and_cache_from_jax_keep_the_new_leaves(name):
    """``params_from_jax`` / ``cache_from_jax`` on a bf16 tree: every
    leaf's path, shape, type and bits, the float32 gate weights, sLSTM
    biases and router and the stacked experts among them; the decode
    cache's float32 states beside its bf16 leaves."""
    jcfg, _ = _cfgs(name, "bfloat16")
    jp, tp = _params(name, "bfloat16")
    jcache = jmodel.init_cache(jcfg, 2, 16)
    jcache = jax.tree.map(lambda a: a + jnp.ones_like(a), jcache)
    tcache = cache_from_jax(jax.tree.map(np.asarray, jcache), "cpu")
    types = set()
    for jtree, ttree in ((jp, tp), (jcache, tcache)):
        jflat, tflat = j_flatten(jtree), tree_flatten_with_paths(ttree)
        assert [p for p, _ in tflat] == [p for p, _ in jflat]
        for (path, got), (_, want) in zip(tflat, jflat):
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape, path
            assert str(got.dtype).split(".")[1] == want.dtype.name, path
            types.add(str(got.dtype))
            assert np.array_equal(_np(got), _np(want)), path
    assert types == {"torch.bfloat16", "torch.float32"}
    if name == "qwen3-moe-30b-a3b":
        assert tp["blocks"]["layer0"]["moe"]["router"].dtype == torch.float32
        assert tuple(tp["blocks"]["layer0"]["moe"]["wi"].shape) == (
            jcfg.n_groups, jcfg.n_experts, jcfg.d_model, jcfg.moe_d_ff)
