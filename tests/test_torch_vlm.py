"""The port's vision-patch frontend against the JAX package's, on the CPU.

The config is the reduced twin of ``llava-next-mistral-7b``
(``cfg.reduced()``: 2 layers, d_model 64, 4 query heads on 2 kv heads of
16, vocab 256, 8 patch positions).  Parameters are made by
``repro.models.model.init_params`` at a seed and carried across
(``repro_torch.convert.params_from_jax``); tokens, labels, the patch
embeddings and their positions (distinct in each row: with duplicates the
JAX package's scatter order is undefined) are made from one numpy seed and
fed to both packages.

Tolerances: ``splice_patches`` equals, exactly, a plain scatter of the
projector's output at the positions, and the JAX package's within 1e-5
of the scale (float32 products in another order); float32 logits, caches
and every parameter's gradient within 1e-4 of their scale; bfloat16
logits and gradients no farther (x2, plus 1e-3 of the scale for logits)
from the float32 results of the same bf16-valued parameters than the JAX
package's bf16 results are (``tests/test_torch_encdec.py`` says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtransformer
from repro.configs import ARCHS
from repro.models import model as jmodel
from repro.parallel.sharding import NO_PARALLEL as J_NOP
from repro.parallel.sharding import ParallelConfig as JPC
from repro.utils.pytree import tree_flatten_with_paths as j_flatten
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttransformer
from repro_torch.parallel.sharding import NO_PARALLEL as T_NOP
from repro_torch.parallel.sharding import ParallelConfig as TPC
from repro_torch.train import step as tstep
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map

NAME = "llava-next-mistral-7b"
F32_TOL, LOGIT_TOL, GRAD_TOL, BF16_RATIO = 1e-5, 1e-4, 1e-4, 2.0
T = 20
_CACHE = {}


def _cfgs(dtype="float32", **kw):
    j = ARCHS[NAME].reduced().replace(param_dtype=dtype, compute_dtype=dtype,
                                      **kw)
    t = tconfigs.get_config(NAME).reduced().replace(
        param_dtype=dtype, compute_dtype=dtype, **kw)
    return j, t


def _params(dtype="float32"):
    """(JAX params, the port's copy), made once per dtype."""
    if dtype not in _CACHE:
        jcfg, _ = _cfgs(dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _CACHE[dtype] = jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu")
    return _CACHE[dtype]


def _batch(cfg, B=2, seed=0, n_tok=T, labels=True):
    """(JAX batch, the port's batch): tokens, next-token labels (the
    first 5 of row 0 ignored), float32 patch embeddings and distinct
    positions in each row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n_tok + 1)).astype(np.int32)
    P = cfg.frontend_positions
    host = {"inputs": toks[:, :-1].copy(),
            "patch_embeds": rng.standard_normal(
                (B, P, cfg.d_model)).astype(np.float32),
            "patch_pos": np.stack([rng.choice(n_tok, P, replace=False)
                                   for _ in range(B)]).astype(np.int32)}
    if labels:
        host["labels"] = toks[:, 1:].copy()
        host["labels"][0, :5] = -1
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


def test_param_tree_matches_jax():
    """The ``frontend`` projector (``w1``, ``w2`` [d, d]) beside the
    decoder-only tree: paths, shapes and types of the JAX tree; the JAX
    parameters carried across bit for bit."""
    jcfg, tcfg = _cfgs("bfloat16")
    flat = tree_flatten_with_paths(tmodel.init_params(
        tcfg, torch.Generator().manual_seed(3), "cpu"))
    jshapes = j_flatten(jmodel.param_shapes(jcfg))
    assert [(p, tuple(t.shape), str(t.dtype).split(".")[1])
            for p, t in flat] == [(p, s.shape, s.dtype.name)
                                  for p, s in jshapes]
    assert "frontend/w2" in {p for p, _ in flat}
    jp, tp = _params("bfloat16")
    for (path, got), (_, want) in zip(tree_flatten_with_paths(tp),
                                      j_flatten(jp)):
        assert np.array_equal(_np(got), _np(want)), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("embed_scale", [False, True])
def test_splice_patches_is_the_plain_scatter(dtype, embed_scale):
    """``splice_patches`` (an inverse-index scatter, then a gather) equals
    a plain scatter of the projector's output, ``gelu_tanh(e @ w1) @ w2``
    (times sqrt(d_model) in the compute type with ``embed_scale``), at the
    positions, exactly, and leaves every other row of ``x`` as it was; in
    float32 it is the JAX package's within 1e-5."""
    jcfg, tcfg = _cfgs(dtype, embed_scale=embed_scale)
    jp, tp = _params(dtype)
    jb, tb = _batch(tcfg, labels=False)
    ct = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, T, tcfg.d_model)).astype(np.float32)).to(ct)
    got = ttransformer.splice_patches(tp, x, tb["patch_embeds"],
                                      tb["patch_pos"], cfg=tcfg, pcfg=T_NOP)
    fp = tp["frontend"]
    proj = torch.nn.functional.gelu(tb["patch_embeds"].to(ct) @ fp["w1"],
                                    approximate="tanh") @ fp["w2"]
    if embed_scale:
        proj = proj * torch.tensor(tcfg.d_model ** 0.5, dtype=ct)
    want = x.clone()
    for b in range(2):
        want[b, tb["patch_pos"][b].long()] = proj[b].to(ct)
    assert got.dtype == ct and torch.equal(got, want)
    others = torch.ones(2, T, dtype=torch.bool)
    for b in range(2):
        others[b, tb["patch_pos"][b].long()] = False
    assert torch.equal(got[others], x[others])
    if dtype == "float32":
        jgot = jtransformer.splice_patches(
            jp, jnp.asarray(x.numpy()), jb["patch_embeds"], jb["patch_pos"],
            cfg=jcfg, pcfg=J_NOP)
        _close(got, jgot, F32_TOL)


def test_forward_matches_jax_float32():
    """The forward with patches spliced in: logits within 1e-4 of the
    scale; without ``patch_embeds`` in the batch the text-only forward,
    as in the JAX package."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    jb, tb = _batch(jcfg)
    with torch.inference_mode():
        for keep in (True, False):
            jbb = jb if keep else {"inputs": jb["inputs"]}
            tbb = tb if keep else {"inputs": tb["inputs"]}
            jl, _ = jmodel.forward(jp, jbb, cfg=jcfg)
            tl, _ = tmodel.forward(tp, tbb, cfg=tcfg)
            _close(tl, jl, LOGIT_TOL)
            if keep:
                with_patches = tl
    assert float((with_patches - tl).abs().max()) > 1e-3


def _jax_grads(dtype):
    if ("grads", dtype) not in _CACHE:
        jcfg, _ = _cfgs(dtype)
        jp, _ = _params(dtype)
        jb, _ = _batch(jcfg)
        pcfg = JPC(mesh=None, remat="none", fused_head=True, head_chunk=16)
        _CACHE["grads", dtype] = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb, cfg=jcfg, pcfg=pcfg),
            has_aux=True))(jp)
    return _CACHE["grads", dtype]


def _port_grads(params, cfg, remat="full"):
    _, tb = _batch(cfg)
    pcfg = TPC(mesh=None, remat=remat, fused_head=True, head_chunk=16)
    return tstep._value_and_grad_accum(params, tb, cfg=cfg, pcfg=pcfg)


def test_loss_fn_and_grads_match_jax_float32():
    """``loss_fn`` (fused head, chunks of 16), its metrics and every
    parameter's gradient, the projector's included, with full remat in
    the port: within 1e-4 of each leaf's scale."""
    (jl, jm), jg = _jax_grads("float32")
    _, tcfg = _cfgs()
    _, tp = _params()
    (tl, tm), tg = _port_grads(tp, tcfg)
    _close(tl, jl, F32_TOL)
    for k in jm:
        _close(tm[k], jm[k], F32_TOL)
    assert float(tg["frontend"]["w2"].abs().max()) > 0
    jflat, tflat = j_flatten(jg), tree_flatten_with_paths(tg)
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (path, got), (_, want) in zip(tflat, jflat):
        _close(got, want, GRAD_TOL)


def test_loss_fn_grads_bf16_as_close_to_float32_as_jax():
    """bf16: each leaf's gradient no farther (x2) from the float32 one of
    the same bf16-valued parameters than the JAX package's bf16 one; the
    loss no farther than twice the JAX package's distance or 2**-8 of
    itself, whichever is larger (one number, read from bf16 logits that
    each carry a rounding of 2**-9: by chance the JAX loss lies 3.6e-4
    from the float32 one here, the port's 2.3e-3)."""
    (jl, _), jg = _jax_grads("bfloat16")
    _, tcfg = _cfgs("bfloat16")
    _, tp = _params("bfloat16")
    (tl, _), tg = _port_grads(tp, tcfg)
    cfg32 = tcfg.replace(param_dtype="float32", compute_dtype="float32")
    (l32, _), g32 = _port_grads(tree_map(lambda x: x.float(), tp), cfg32,
                                remat="none")
    assert abs(float(tl) - float(l32)) <= max(
        BF16_RATIO * abs(float(jl) - float(l32)), 2 ** -8 * float(l32))
    for (path, truth), (_, jgot), (_, tgot) in zip(
            tree_flatten_with_paths(g32), j_flatten(jg),
            tree_flatten_with_paths(tg)):
        t = truth.double().numpy()
        ej = np.linalg.norm(np.asarray(jgot, np.float64) - t)
        ep = np.linalg.norm(tgot.double().numpy() - t)
        assert ep <= BF16_RATIO * ej + 1e-6 * np.linalg.norm(t), \
            (path, ep, ej)


def test_prefill_with_patches_and_decode_match_jax_float32():
    """``prefill`` with the patches spliced in (the JAX package's route
    for an image prompt), last logits and cache; then three decode steps,
    each from the JAX package's cache carried across."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params()
    jb, tb = _batch(jcfg, seed=4, labels=False)
    jl, jc = jmodel.prefill(jp, jb, cfg=jcfg, max_len=32)
    with torch.inference_mode():
        tl, tc = tmodel.prefill(tp, tb, cfg=tcfg, max_len=32)
    _close(tl, jl, LOGIT_TOL)
    for (path, got), (_, want) in zip(tree_flatten_with_paths(tc),
                                      j_flatten(jc)):
        _close(got, want, LOGIT_TOL)
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


def test_decode_continues_the_forward():
    """Float32: a prefill of T - 1 tokens with the patches (all at
    positions below T - 1) and one decode step give the full forward's
    last two logit rows within 1e-4 of their scale."""
    _, tcfg = _cfgs()
    _, tp = _params()
    _, tb = _batch(tcfg, seed=6, n_tok=T - 1, labels=False)
    toks = torch.cat([tb["inputs"], torch.full((2, 1), 7,
                                               dtype=torch.int32)], 1)
    with torch.inference_mode():
        full, _ = tmodel.forward(tp, dict(tb, inputs=toks), cfg=tcfg)
        last, cache = tmodel.prefill(tp, tb, cfg=tcfg, max_len=T + 4)
        dec, _ = tmodel.decode_step(tp, cache, toks[:, T - 1:],
                                    torch.full((2,), T - 1,
                                               dtype=torch.int32), cfg=tcfg)
    _close(last, full[:, T - 2], LOGIT_TOL)
    _close(dec, full[:, T - 1], LOGIT_TOL)


def test_bf16_logits_as_close_to_float32_as_jax():
    """bf16: the forward's and prefill's logits with patches, and a decode
    step's, no farther (x2, plus 1e-3 of the scale) from the float32
    logits of the same bf16-valued parameters than the JAX package's."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params("bfloat16")
    cfg32 = tcfg.replace(param_dtype="float32", compute_dtype="float32")
    tp32 = tree_map(lambda a: a.float(), tp)
    jb, tb = _batch(jcfg, seed=7, labels=False)
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
