"""The port's training path against the JAX package's, on the CPU.

Parameters are made by ``repro.models.model.init_params`` at a seed and
carried across leaf for leaf (``repro_torch.convert.params_from_jax``;
the AdamW state by ``opt_state_from_jax``); tokens, labels and other
inputs are made from one numpy seed and fed to both packages.  The
configs are the reduced twins (``cfg.reduced()``) of
``recurrentgemma-2b`` (R and L layers) and ``qwen2.5-3b`` (A layers),
the xLSTM and MoE families, and the dense configs held last
(``gemma3-12b``, ``qwen3-8b``, ``deepseek-7b``; ``dbrx-132b`` in the
train step of the new families).

Tolerances:
- float32 losses, metrics and gradients within 1e-5 (relative to the
  largest magnitude of each array): the same arithmetic, sums in another
  order; a whole model's parameter gradients within 1e-4 (26 layers and
  the recurrence compound those differences); the AdamW state within rtol 1e-5 / atol 1e-7 after several
  steps, the learning rate within rtol 1e-6 (float32 ``cos``); a K-step
  train step's parameters within 1e-4 of their scale plus 5% of the
  learning rate: Adam divides each gradient by its own RMS, so a leaf
  whose gradient is float32 noise (the key bias, to which attention is
  nearly invariant) moves by steps of about lr in directions the noise
  picks, in either package.
- bfloat16 gradients: both packages round at other places (XLA fuses
  elementwise chains in float32, torch rounds each op; the port's
  attention keeps p in float32), and at random weights either package's
  bf16 gradients lie 5-20% (in norm) from the float32 gradients of the
  same bf16-valued parameters.  So each leaf's distance from those
  float32 gradients must be at most twice the JAX package's own, and the
  loss within 1e-2 of the JAX loss (the bf16 logits carry a relative
  rounding of 2**-9 each; a loss near 6 moves by up to about 0.01).
- Checkpoints: bit for bit, both directions, and the same payload bytes.
- ``Trainer`` loss histories (float32, 4 steps) within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
import repro.models.losses as jlosses
import repro.models.rglru as jrglru
from conftest import make_cloud
from repro.configs import ARCHS
from repro.data import DataPipeline as JPipeline
from repro.data import SectorTokenDataset as JDataset
from repro.data import write_synthetic_corpus as j_write_corpus
from repro.models import model as jmodel
from repro.parallel.sharding import ParallelConfig as JPC
from repro.train import SectorCheckpointer as JCheckpointer
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import optim as joptim
from repro.train import step as jstep
from repro.utils.pytree import tree_flatten_with_paths as j_flatten
from repro_torch import configs as tconfigs
from repro_torch import sector as tsector
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import DataPipeline, SectorTokenDataset
from repro_torch.data import write_synthetic_corpus
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rg_lru_scan import lru_scan_ref
from repro_torch.kernels.rg_lru_scan import ops as lru_ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import losses as tlosses
from repro_torch.models import model as tmodel
from repro_torch.models import rglru as trglru
from repro_torch.parallel.sharding import ParallelConfig as TPC
from repro_torch.train import SectorCheckpointer, Trainer, TrainerConfig
from repro_torch.train import optim
from repro_torch.train import step as tstep
from repro_torch.train.checkpoint import deserialize, serialize
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_map
from torch_held import DENSE

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_RATIO = 2.0
_CACHE = {}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _close(got, want, tol=F32_TOL):
    """Within ``tol`` of the larger array's largest magnitude."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max(initial=0)), 1e-30)
    err = float(np.abs(g - w).max(initial=0))
    assert err <= tol * scale, (err, scale)


def _cfgs(name, dtype="float32"):
    j = ARCHS[name].reduced().replace(param_dtype=dtype, compute_dtype=dtype)
    t = tconfigs.get_config(name).reduced().replace(param_dtype=dtype,
                                                    compute_dtype=dtype)
    return j, t


def _params(name, dtype="float32"):
    """(JAX params, the port's copy), made once per config."""
    if ("params", name, dtype) not in _CACHE:
        jcfg, _ = _cfgs(name, dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        _CACHE["params", name, dtype] = jp, params_from_jax(
            jax.tree.map(np.asarray, jp), "cpu")
    return _CACHE["params", name, dtype]


def _batch(vocab, B=2, T=48, seed=0, ignore=5, cfg=None):
    """(JAX batch, the port's batch): random tokens, the first ``ignore``
    labels of row 0 set to -1; with ``cfg`` the frontend's inputs as
    ``models/inputs.py::train_batch_specs`` shapes them, float32 from
    the same seed: an encoder-decoder's ``enc_frames`` [B, T, d_model],
    a vision config's ``patch_embeds`` [B, P, d_model] and distinct
    ``patch_pos`` [B, P] in each row."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T + 1)).astype(np.int32)
    inputs, labels = toks[:, :-1].copy(), toks[:, 1:].copy()
    labels[0, :ignore] = -1
    host = {"inputs": inputs, "labels": labels}
    if cfg is not None and cfg.is_encoder_decoder:
        host["enc_frames"] = rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
    if cfg is not None and cfg.frontend == "vision_patches":
        P = cfg.frontend_positions
        host["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
        host["patch_pos"] = np.stack([rng.choice(T, P, replace=False)
                                      for _ in range(B)]).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def _flat(tree):
    return [x for _, x in tree_flatten_with_paths(tree)]


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("vp,real_vocab", [(12, 12), (16, 11)])
def test_cross_entropy_matches_jax(vp, real_vocab):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, vp)).astype(np.float32) * 3
    labels = rng.integers(0, real_vocab, (2, 7)).astype(np.int32)
    labels[1, :3] = -1

    def jloss(x):
        return jlosses.cross_entropy(x, jnp.asarray(labels),
                                     real_vocab=real_vocab)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tl, tm = tlosses.cross_entropy(x, torch.from_numpy(labels),
                                   real_vocab=real_vocab)
    tl.backward()
    _close(tl, jl)
    for k in jm:
        _close(tm[k], jm[k])
    _close(x.grad, jg)


@pytest.mark.parametrize("transpose_w", [True, False])
@pytest.mark.parametrize("chunk", [16, 512])
def test_fused_cross_entropy_matches_jax(transpose_w, chunk):
    """24 tokens in chunks of 8 (16 does not divide 24) or one chunk;
    a padded vocab of 40 of which 37 are real."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((40, 16) if transpose_w else (16, 40)) \
        .astype(np.float32) * 0.3
    labels = rng.integers(0, 37, (2, 24)).astype(np.int32)
    labels[0, 20:] = -1

    def jloss(x, w):
        return jlosses.fused_cross_entropy(
            x, w, jnp.asarray(labels), real_vocab=37,
            transpose_w=transpose_w, chunk=chunk)
    (jl, jm), (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tl, tm = tlosses.fused_cross_entropy(
        tx, tw, torch.from_numpy(labels), real_vocab=37,
        transpose_w=transpose_w, chunk=chunk)
    tl.backward()
    _close(tl, jl)
    for k in jm:
        _close(tm[k], jm[k])
    _close(tx.grad, jgx)
    _close(tw.grad, jgw)
    # the chunked loss is the materialised one
    logits = tx @ (tw.t() if transpose_w else tw)
    _close(tlosses.cross_entropy(logits, torch.from_numpy(labels),
                                 real_vocab=37)[0], tl)


# ------------------------------------------------------ kernel gradients
def test_rg_lru_scan_gradient_matches_jax_lru():
    """Gradients of the RG-LRU (gates, ``a``, ``b`` and the recurrence
    through the ``rg_lru_scan`` Function) against ``jax.grad`` of the
    JAX package's ``_lru`` (an associative scan), for every parameter,
    the input and ``h0``."""
    jcfg, _ = _cfgs("recurrentgemma-2b")
    jp, tp = _params("recurrentgemma-2b")
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["layer0"]["rglru"])
    tl = tree_map(lambda a: a[0].clone().requires_grad_(),
                  tp["blocks"]["layer0"]["rglru"])
    rng = np.random.default_rng(2)
    w = jcfg.lru_width
    x = rng.standard_normal((2, 19, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    gy = rng.standard_normal((2, 19, w)).astype(np.float32)
    gh = rng.standard_normal((2, w)).astype(np.float32)

    def jf(p, x, h0):
        y, h_t = jrglru._lru(p, x, h0)
        return jnp.sum(y * gy) + jnp.sum(h_t * gh)
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(jl, jnp.asarray(x),
                                                  jnp.asarray(h0))
    tx, th0 = (torch.from_numpy(a).requires_grad_() for a in (x, h0))
    y, h_t = trglru._lru(tl, tx, th0)
    ((y * torch.from_numpy(gy)).sum()
     + (h_t * torch.from_numpy(gh)).sum()).backward()
    for path, leaf in tree_flatten_with_paths(tl):
        want = dict(j_flatten(jg[0]))[path]
        if path in ("in_x", "in_g", "conv_w", "out"):   # outside _lru
            assert leaf.grad is None and not np.asarray(want).any(), path
        else:
            _close(leaf.grad, want)
    _close(tx.grad, jg[1])
    _close(th0.grad, jg[2])


@pytest.mark.parametrize("T", [0, 1, 2, 37])
def test_rg_lru_scan_backward_is_autograd_through_the_loop(T):
    """The Function's time-reversed backward against autograd through the
    plain loop, exactly (the same multiplies and adds)."""
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, T, 8)).astype(np.float32))
    b, g = (torch.from_numpy(rng.standard_normal((3, T, 8))
                             .astype(np.float32)) for _ in range(2))
    h0, gl = (torch.from_numpy(rng.standard_normal((3, 8))
                               .astype(np.float32)) for _ in range(2))
    got, want = [], []
    for fn, out in ((lru_ops.rg_lru_scan, got), (lru_scan_ref, want)):
        ins = [t.clone().requires_grad_() for t in (a, b, h0)]
        h, h_last = fn(*ins)
        out.extend(torch.autograd.grad((h * g).sum() + (h_last * gl).sum(),
                                       ins, allow_unused=True))
    for x, y in zip(got, want):
        assert torch.equal(x, y if y is not None else torch.zeros_like(x))


@pytest.mark.parametrize("H,K,window", [(4, 2, 0), (4, 2, 7), (2, 2, 0),
                                        (4, 1, 5)])
def test_flash_attention_gradient_matches_jax_scan(H, K, window):
    """Gradients of the ``flash_attention`` Function (the plain version
    recomputed row by row) against ``jax.grad`` of ``chunked_attention``
    with ``impl="scan"``, the JAX package's training attention."""
    rng = np.random.default_rng(H * 10 + window)
    B, T, D = 3, 20, 8
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, K, D)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)

    def jf(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=True, window=window,
                                      q_chunk=8, kv_chunk=8, impl="scan")
        return jnp.sum(out * g)
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_ops.flash_attention(*ins, causal=True, window=window)
    tg = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ins)
    for got, want in zip(tg, jg):
        _close(got, want)
    # and against autograd through the whole-batch plain version
    ins2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out2 = flash_attention_ref(*ins2, causal=True, window=window)
    for got, want in zip(tg, torch.autograd.grad(
            (out2 * torch.from_numpy(g)).sum(), ins2)):
        _close(got, want, 1e-6)


# ------------------------------------------------------- loss_fn / grads
def _jax_grads(name, dtype, fused):
    key = ("grads", name, dtype, fused)
    if key not in _CACHE:
        jcfg, _ = _cfgs(name, dtype)
        jp, _ = _params(name, dtype)
        jb, _ = _batch(jcfg.vocab_size)
        pcfg = JPC(mesh=None, remat="none", fused_head=fused, head_chunk=32)
        _CACHE[key] = jax.jit(jax.value_and_grad(
            lambda p: jmodel.loss_fn(p, jb, cfg=jcfg, pcfg=pcfg),
            has_aux=True))(jp)
    return _CACHE[key]


def _port_grads(name, dtype, fused, remat="full"):
    _, tcfg = _cfgs(name, dtype)
    _, tp = _params(name, dtype)
    _, tb = _batch(tcfg.vocab_size)
    pcfg = TPC(mesh=None, remat=remat, fused_head=fused, head_chunk=32)
    return tstep._value_and_grad_accum(tp, tb, cfg=tcfg, pcfg=pcfg)


@pytest.mark.parametrize("name,fused", [("recurrentgemma-2b", True),
                                        ("qwen2.5-3b", True),
                                        ("qwen2.5-3b", False),
                                        ("qwen3-moe-30b-a3b", True)]
                         + [(name, True) for name in DENSE])
def test_loss_fn_and_grads_match_jax_float32(name, fused):
    """``loss_fn`` (the fused head chunked by 32 of the 48 tokens, or
    materialised logits), its metrics and every parameter's gradient,
    with full remat in the port.  ``gemma3-12b``'s head is its scaled,
    tied embedding, so ``embed/w`` sums both uses' gradients."""
    (jl, jm), jg = _jax_grads(name, "float32", fused)
    (tl, tm), tg = _port_grads(name, "float32", fused)
    _close(tl, jl)
    for k in jm:
        _close(tm[k], jm[k])
    jflat = j_flatten(jg)
    assert [p for p, _ in jflat] == [p for p, _ in
                                     tree_flatten_with_paths(tg)]
    for (path, want), got in zip(jflat, _flat(tg)):
        _close(got, want, GRAD_TOL)


def _one_ulp(jp, seed):
    """The JAX parameters with every float32 embedding entry moved by one
    ulp (signs drawn from ``seed``): what the JAX package's own outputs
    move under it is the spread a float32 comparison can expect."""
    e = np.asarray(jp["embed"]["w"])
    sign = np.random.default_rng(seed).choice([-1.0, 1.0], e.shape)
    return dict(jp, embed={"w": jnp.asarray(
        (e * (1 + 2.0 ** -23 * sign)).astype(np.float32))})


def test_xlstm_loss_fn_and_grads_within_the_jax_spread():
    """Reduced ``xlstm-1.3b`` (float32, fused head): the loss and its
    metrics within 1e-5, and each gradient leaf within 1e-4 of its norm
    plus three times the JAX package's own spread (in norm): the larger
    distance its gradient moves when its embedding table moves by one
    ulp, over two draws of the signs.  Through 16 layers of mLSTM /
    sLSTM at random weights that spread is about 1e-3 of a leaf's norm,
    and the port's distance lies between 0.5 and 2.6 times one draw's
    (``tests/test_torch_models.py::test_new_families_match_jax_float32``
    says why); the sLSTM's ``b_i`` gradient is all such noise."""
    name = "xlstm-1.3b"
    (jl, jm), jg = _jax_grads(name, "float32", True)
    (tl, tm), tg = _port_grads(name, "float32", True)
    _close(tl, jl)
    for k in jm:
        _close(tm[k], jm[k])
    jcfg, _ = _cfgs(name)
    jp, _ = _params(name)
    jb, _ = _batch(jcfg.vocab_size)
    pcfg = JPC(mesh=None, remat="none", fused_head=True, head_chunk=32)
    grad = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, cfg=jcfg, pcfg=pcfg), has_aux=True))
    spreads = []
    for seed in (0, 1):
        _, ug = grad(_one_ulp(jp, seed))
        spreads.append([np.linalg.norm(np.asarray(u, np.float64)
                                       - np.asarray(w, np.float64))
                        for (_, u), (_, w) in zip(j_flatten(ug),
                                                  j_flatten(jg))])
    for (path, want), got, spread in zip(j_flatten(jg), _flat(tg),
                                         np.max(spreads, axis=0)):
        w = np.asarray(want, np.float64)
        err = np.linalg.norm(_np(got).astype(np.float64) - w)
        assert err <= GRAD_TOL * np.linalg.norm(w) + 3 * spread, \
            (path, err, spread)


def _global_norm(leaves):
    return float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in leaves)))


def test_xlstm_gradient_norm_grows_with_depth_as_in_jax():
    """Reduced ``xlstm-1.3b`` at all 48 of its layers (float32, the fused
    head, 2 x 48 tokens: below 64, from which the JAX package's mLSTM
    gradient is NaN): the global gradient norm grows with depth in the
    JAX package itself, in each draw more than 20 times its norm at the
    reduced 16 layers (35 to 125 times), and the port's grows so too and
    lies within three times the JAX package's own spread there (in log:
    the most its norm moves when its embedding table moves by one ulp,
    over two draws of the signs; the random-weight stack of 48 layers is
    chaotic in float32, and those draws move the norm by a factor of
    about 3.6).  The full-width stack's gradient norm on the card grows
    so too."""
    name = "xlstm-1.3b"
    jcfg, tcfg = (c.replace(n_layers=48) for c in _cfgs(name))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jb, tb = _batch(jcfg.vocab_size)
    pcfg = JPC(mesh=None, remat="none", fused_head=True, head_chunk=32)
    grad = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jb, cfg=jcfg, pcfg=pcfg), has_aux=True))
    draws = [_global_norm(g for _, g in j_flatten(grad(p)[1]))
             for p in (jp, _one_ulp(jp, 0), _one_ulp(jp, 1))]
    want = draws[0]
    spread = max(abs(np.log(d / want)) for d in draws[1:])
    _, g16 = _jax_grads(name, "float32", True)
    shallow = _global_norm(g for _, g in j_flatten(g16))
    _, tg = tstep._value_and_grad_accum(
        tp, tb, cfg=tcfg, pcfg=TPC(mesh=None, remat="full", fused_head=True,
                                   head_chunk=32))
    got = _global_norm(_np(g) for g in _flat(tg))
    assert min(draws + [got]) > 20 * shallow, (draws, got, shallow)
    assert abs(np.log(got / want)) <= 3 * spread, (got, want, spread)


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "qwen2.5-3b"] + DENSE)
def test_loss_fn_grads_bf16_as_close_to_float32_as_jax(name):
    """bf16 parameters: each leaf's gradient is no farther (x2) from the
    float32 gradient of the same bf16-valued parameters than the JAX
    package's bf16 gradient is.  The float32 gradients are the port's
    (held to the JAX package's within 1e-4 above)."""
    (jl, _), jg = _jax_grads(name, "bfloat16", True)
    (tl, _), tg = _port_grads(name, "bfloat16", True)
    _, tcfg = _cfgs(name, "bfloat16")
    _, tp = _params(name, "bfloat16")
    _, tb = _batch(tcfg.vocab_size)
    cfg32 = tcfg.replace(param_dtype="float32", compute_dtype="float32")
    _, g32 = tstep._value_and_grad_accum(
        tree_map(lambda x: x.float(), tp), tb, cfg=cfg32,
        pcfg=TPC(mesh=None, remat="none", fused_head=True, head_chunk=32))
    assert abs(float(tl) - float(jl)) <= 1e-2
    for (path, truth), (_, jgot), tgot, p in zip(
            tree_flatten_with_paths(g32), j_flatten(jg), _flat(tg),
            _flat(tp)):
        assert tgot.dtype == p.dtype, path
        t = truth.double().numpy()
        ej = np.linalg.norm(np.asarray(jgot, np.float64) - t)
        ep = np.linalg.norm(tgot.double().numpy() - t)
        assert ep <= BF16_RATIO * ej + 1e-6 * np.linalg.norm(t), \
            (path, ep, ej)


def test_remat_policies_give_the_same_gradients():
    """``remat`` none / full / dots: the same loss and gradients, bit for
    bit (checkpointing recomputes the same ops)."""
    (l0, _), g0 = _port_grads("recurrentgemma-2b", "float32", True, "none")
    for remat in ("full", "dots"):
        (l1, _), g1 = _port_grads("recurrentgemma-2b", "float32", True,
                                  remat)
        assert torch.equal(l0, l1), remat
        assert all(torch.equal(a, b) for a, b in zip(_flat(g0), _flat(g1))), \
            remat
    with pytest.raises(ValueError):
        _port_grads("qwen2.5-3b", "float32", True, "some")


# ------------------------------------------------------------- optimizer
def test_adamw_matches_reference():
    """One AdamW step vs hand-computed update on a toy param."""
    ocfg = optim.AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8,
                             weight_decay=0.0, grad_clip=0.0)
    params = {"layer": {"w": torch.ones(3)}}
    grads = {"layer": {"w": torch.tensor([0.5, -0.5, 1.0])}}
    state = optim.init_state(params, ocfg)
    new_p, new_s, _ = optim.apply_updates(params, grads, state, ocfg,
                                          lambda s: 0.1)
    g = np.asarray([0.5, -0.5, 1.0])
    m = 0.1 * g
    v = 0.001 * g**2
    upd = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
    want = 1.0 - 0.1 * upd
    np.testing.assert_allclose(new_p["layer"]["w"].numpy(), want, rtol=1e-5)
    assert new_p is params and int(new_s["step"]) == 1


def test_weight_decay_skips_norms():
    ocfg = optim.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    params = {"norm": {"scale": torch.ones(3)}, "mlp": {"wi": torch.ones(3)},
              "rglru": {"a_param": torch.ones(3)}, "attn": {"bq": torch.ones(3),
                                                            "q_norm": torch.ones(3)}}
    grads = tree_map(torch.zeros_like, params)
    state = optim.init_state(params, ocfg)
    new_p, _, _ = optim.apply_updates(params, grads, state, ocfg,
                                      lambda s: 0.1)
    for path, p in tree_flatten_with_paths(new_p):
        moved = float((p - 1.0).abs().max())
        assert (moved > 1e-3) == (path == "mlp/wi"), path
        assert optim._decay_mask(path) == joptim._decay_mask(path)


def test_grad_clip_effective():
    ocfg = optim.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 100.0)}
    state = optim.init_state(params, ocfg)
    _, _, metrics = optim.apply_updates(params, grads, state, ocfg,
                                        lambda s: 1.0)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_master_weights_do_not_alias_float32_params():
    params = {"w": torch.ones(4), "h": torch.ones(2, dtype=torch.bfloat16)}
    state = optim.init_state(params, optim.AdamWConfig())
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert state["master"]["h"].dtype == torch.float32


def test_warmup_cosine_matches_jax():
    jf, tf = joptim.warmup_cosine(3e-4, 5, 25), optim.warmup_cosine(3e-4, 5,
                                                                    25)
    for s in range(32):
        np.testing.assert_allclose(float(tf(s)), float(jf(s)), rtol=1e-6)
        np.testing.assert_allclose(
            float(tf(torch.tensor(s, dtype=torch.int32))), float(jf(s)),
            rtol=1e-6)


def test_apply_updates_matches_jax_over_steps():
    """Six AdamW steps with warm-up, clipping and decay on a tree of
    float32 and bf16 leaves (some decay-masked), from random gradients."""
    rng = np.random.default_rng(4)
    shapes = {"mlp": {"wi": (6, 5)}, "norm": {"scale": (5,)},
              "rglru": {"a_param": (5,)}, "embed": {"w": (7, 5)}}
    jp = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s),
                                            jnp.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    jp["embed"]["w"] = jp["embed"]["w"].astype(jnp.bfloat16)
    ocfg_j = joptim.AdamWConfig(lr=1e-2, grad_clip=0.5)
    ocfg_t = optim.AdamWConfig(lr=1e-2, grad_clip=0.5)
    lr_j, lr_t = (mod.warmup_cosine(1e-2, 2, 6) for mod in (joptim, optim))
    js = joptim.init_state(jp, ocfg_j)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = optim.init_state(tp, ocfg_t)
    for i in range(6):
        g = jax.tree.map(lambda p: np.asarray(
            rng.standard_normal(p.shape) * (i + 1), np.float32)
            .astype(p.dtype), jp)
        jp, js, jm = joptim.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                          js, ocfg_j, lr_j)
        tp, ts, tm = optim.apply_updates(tp, params_from_jax(g, "cpu"), ts,
                                         ocfg_t, lr_t)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 6
    for tree in ("m", "v", "master"):
        for (path, want), got in zip(j_flatten(js[tree]), _flat(ts[tree])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7, err_msg=path)
    for (path, want), got in zip(j_flatten(jp), _flat(tp)):
        assert str(got.dtype).endswith(str(want.dtype)), path
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -8,
                                   atol=1e-7, err_msg=path)


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """Three train steps of reduced qwen2.5-3b (float32) from the same
    converted parameters and AdamW state (after one JAX step, so the
    moments are not zero), on the same batches, with and without
    gradient accumulation."""
    name = "qwen2.5-3b"
    jcfg, tcfg = _cfgs(name)
    jp, _ = _params(name)
    ocfg_j, ocfg_t = joptim.AdamWConfig(lr=1e-3), optim.AdamWConfig(lr=1e-3)
    lr_j, lr_t = (mod.warmup_cosine(1e-3, 1, 8) for mod in (joptim, optim))
    jpc = JPC(mesh=None, remat="none", accum_steps=accum)
    tpc = TPC(mesh=None, remat="full", accum_steps=accum)
    jfn = jax.jit(jstep.make_train_step(jcfg, jpc, ocfg_j, lr_j))
    tfn = tstep.make_train_step(tcfg, tpc, ocfg_t, lr_t)
    js = joptim.init_state(jp, ocfg_j)
    jp, js, _ = jfn(jp, js, _batch(jcfg.vocab_size, B=4, T=16, seed=9)[0])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for i in range(3):
        jb, tb = _batch(jcfg.vocab_size, B=4, T=16, seed=10 + i)
        jp, js, jm = jfn(jp, js, jb)
        tp, ts, tm = tfn(tp, ts, tb)
        for k in jm:
            _close(tm[k], jm[k])
    assert int(ts["step"]) == int(js["step"]) == 4
    for tree_j, tree_t in ((jp, tp), (js["master"], ts["master"])):
        for (path, want), got in zip(j_flatten(tree_j), _flat(tree_t)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                _np(got), want, rtol=0,
                atol=1e-4 * np.abs(want).max() + 5e-2 * 1e-3, err_msg=path)


@pytest.mark.parametrize("name", ["xlstm-1.3b", "qwen3-moe-30b-a3b",
                                  "dbrx-132b", "seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_train_step_of_the_new_families_matches_jax(name):
    """One train step of reduced ``xlstm-1.3b`` / ``qwen3-moe-30b-a3b`` /
    ``dbrx-132b``, and of ``seamless-m4t-large-v2`` (with frames) and
    ``llava-next-mistral-7b`` (with patches, ``_batch(cfg=)``), as the
    JAX package trains those two through ``make_train_step`` (float32,
    full remat in the port) from the same parameters and AdamW
    state (after one JAX step, so the moments are not zero), on the same
    batch: the step's metrics (the MoE aux loss among them) and the
    parameters after it (each leaf in norm), by the bounds of
    ``test_train_step_matches_jax`` plus three times the JAX package's
    own spread, what its metrics and parameters move when its embedding
    table moves by one ulp (about
    1e-3 of the xLSTM's gradient norm; below 1e-5 of the MoE's, see
    ``test_xlstm_loss_fn_and_grads_within_the_jax_spread``)."""
    jcfg, tcfg = _cfgs(name)
    jp, _ = _params(name)
    ocfg_j, ocfg_t = joptim.AdamWConfig(lr=1e-3), optim.AdamWConfig(lr=1e-3)
    lr_j, lr_t = (mod.warmup_cosine(1e-3, 1, 8) for mod in (joptim, optim))
    jfn = jax.jit(jstep.make_train_step(jcfg, JPC(mesh=None, remat="none"),
                                        ocfg_j, lr_j))
    tfn = tstep.make_train_step(tcfg, TPC(mesh=None, remat="full"), ocfg_t,
                                lr_t)
    jp, js, _ = jfn(jp, joptim.init_state(jp, ocfg_j),
                    _batch(jcfg.vocab_size, B=2, T=16, seed=11, cfg=jcfg)[0])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    jb, tb = _batch(jcfg.vocab_size, B=2, T=16, seed=12, cfg=jcfg)
    up, _, um = jfn(_one_ulp(jp, 0), js, jb)
    jp, js, jm = jfn(jp, js, jb)
    tp, ts, tm = tfn(tp, ts, tb)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        spread = abs(float(um[k]) - float(jm[k])) / max(abs(float(jm[k])),
                                                        1e-30)
        _close(tm[k], jm[k], max(F32_TOL, 3 * spread))
    assert (float(tm["aux_loss"]) > 0) == (tcfg.family == "moe")
    assert int(ts["step"]) == int(js["step"]) == 2
    for (path, want), (_, ulp), got in zip(j_flatten(jp), j_flatten(up),
                                           _flat(tp)):
        want = np.asarray(want, np.float64)
        spread = np.linalg.norm(np.asarray(ulp, np.float64) - want)
        err = np.linalg.norm(_np(got).astype(np.float64) - want)
        assert err <= 1e-4 * np.linalg.norm(want) + 5e-2 * 1e-3 * np.sqrt(
            want.size) + 3 * spread, (path, err, spread)


def test_opt_state_from_jax_keeps_types_and_bits():
    jp, _ = _params("recurrentgemma-2b", "bfloat16")
    js = joptim.init_state(jp, joptim.AdamWConfig())
    ts = opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for (path, want), got in zip(j_flatten(js), _flat(ts)):
        assert np.array_equal(_np(got), np.asarray(want)), path
    with pytest.raises(ValueError):
        opt_state_from_jax({**jax.tree.map(np.asarray, js), "mu": {}}, "cpu")
    # the int8_ef residual converts like the moments
    je = joptim.init_state(jp, joptim.AdamWConfig(error_feedback=True))
    te = opt_state_from_jax(jax.tree.map(np.asarray, je), "cpu")
    for (path, want), got in zip(j_flatten(je), _flat(te)):
        assert np.array_equal(_np(got), np.asarray(want)), path


# ------------------------------------------------------------ checkpoints
def _state_trees(dtype="bfloat16"):
    """A JAX {params, opt} tree (after one optimizer step) and its copy."""
    jp, _ = _params("recurrentgemma-2b", dtype)
    js = joptim.init_state(jp, joptim.AdamWConfig())
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp2, js2, _ = joptim.apply_updates(jp, grads, js, joptim.AdamWConfig(),
                                       joptim.warmup_cosine(1e-3, 1, 4))
    jtree = {"params": jp2, "opt": js2}
    ttree = {"params": params_from_jax(jax.tree.map(np.asarray, jp2), "cpu"),
             "opt": opt_state_from_jax(jax.tree.map(np.asarray, js2), "cpu")}
    return jtree, ttree


def _port_cloud(tmp_path, chunk_size=4096):
    master = tsector.SectorMaster(chunk_size=chunk_size)
    for i, site in enumerate(master.topology.sites):
        master.register(tsector.ChunkServer(f"s{i}", site, tmp_path))
    master.acl.add_member("alice")
    master.acl.grant_write("alice")
    return master, tsector.SectorClient(master, "alice", "chicago")


def _copy_checkpoint(src_client, dst_client, names):
    for name in names:
        dst_client.upload(name, src_client.download(name), replication=2)


def test_serialize_is_the_jax_format_byte_for_byte():
    from repro.train.checkpoint import serialize as j_serialize
    jtree, ttree = _state_trees()
    jpay, jman = j_serialize(jtree)
    tpay, tman = serialize(ttree)
    assert tpay == jpay
    assert tman == jman


def test_jax_checkpoint_restores_in_port_bit_for_bit(tmp_path):
    jmaster, _, jclient = make_cloud(tmp_path / "j", chunk_size=4096)
    _, tclient = _port_cloud(tmp_path / "t")
    jtree, ttree = _state_trees()
    jck = JCheckpointer(jclient, "x")
    jck.save(3, {**jtree, "extra": {"cursor": {"epoch": 1, "index": 2,
                                               "batch": 0}}})
    _copy_checkpoint(jclient, tclient, [jck._bin(3), jck._man(3)])
    got = SectorCheckpointer(tclient, "x").restore_latest(
        tree_map(lambda x: x, ttree))
    assert got["step"] == 3 and got["extra"]["cursor"]["epoch"] == 1
    for (path, want), back in zip(tree_flatten_with_paths(ttree),
                                  _flat({"params": got["params"],
                                         "opt": got["opt"]})):
        assert back.dtype == want.dtype and torch.equal(back, want), path


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    _, _, jclient = make_cloud(tmp_path / "j", chunk_size=4096)
    _, tclient = _port_cloud(tmp_path / "t")
    jtree, ttree = _state_trees()
    tck = SectorCheckpointer(tclient, "y")
    tck.save(5, {**ttree, "extra": {}})
    _copy_checkpoint(tclient, jclient, [tck._bin(5), tck._man(5)])
    got = JCheckpointer(jclient, "y").restore_latest(jtree)
    assert got["step"] == 5
    for (path, want), (_, back) in zip(j_flatten(jtree), j_flatten(
            {"params": got["params"], "opt": got["opt"]})):
        assert back.dtype == want.dtype, path
        assert bool((back == want).all()), path


def test_serialize_roundtrip_bf16():
    tree = {"a": (torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)}}
    payload, manifest = serialize(tree)
    back = deserialize(payload, manifest, tree)
    for x, y in zip(_flat(tree), _flat(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_atomicity_corrupt_payload(tmp_path):
    """A corrupted newest checkpoint must fall back to the previous one."""
    master, client = _port_cloud(tmp_path, chunk_size=2048)
    ck = SectorCheckpointer(client, "t", replication=2)
    tree = {"params": {"w": torch.ones(8)}, "opt": {"m": torch.zeros(8)}}
    ck.save(1, {"params": tree["params"], "opt": tree["opt"]})
    ck.save(2, {"params": {"w": tree["params"]["w"] * 2},
                "opt": tree["opt"]})
    fm = master.files[ck._bin(2)]
    for cid in fm.chunk_ids:
        for sid in master.chunks[cid].locations:
            master.servers[sid]._path(cid).write_bytes(b"garbage")
    got = ck.restore_latest(tree)
    assert got is not None and got["step"] == 1
    assert float(got["params"]["w"][0]) == 1.0


# ------------------------------------------------------ data and trainer
def test_pipeline_matches_jax_and_resumes(tmp_path):
    """The same corpus in both clouds: the same batches in order (int32
    tensors), and a pipeline resumed from a cursor continues the stream."""
    _, _, jclient = make_cloud(tmp_path / "j", chunk_size=8192)
    jmaster = jclient.master
    tmaster, tclient = _port_cloud(tmp_path / "t", chunk_size=8192)
    for c in (jclient, tclient):
        (j_write_corpus if c is jclient else write_synthetic_corpus)(
            c, "c", 20_000, 256, seed=1)
    jpipe = JPipeline(JDataset(jmaster, jclient, "c", seq_len=15), batch=3,
                      pcfg=JPC(mesh=None))
    tpipe = DataPipeline(SectorTokenDataset(tmaster, tclient, "c",
                                            seq_len=15),
                         batch=3, pcfg=TPC(mesh=None), device="cpu")
    jit, tit = iter(jpipe), iter(tpipe)
    stream = []
    for _ in range(6):
        jb, tb = next(jit), next(tit)
        for k in ("inputs", "labels"):
            assert tb[k].dtype == torch.int32
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
        stream.append(tb)
        assert tpipe.state_dict() == jpipe.state_dict()
        if len(stream) == 3:
            cursor = tpipe.state_dict()
    again = DataPipeline(SectorTokenDataset(tmaster, tclient, "c",
                                            seq_len=15),
                         batch=3, pcfg=TPC(mesh=None), device="cpu")
    again.load_state_dict(cursor)
    resumed = iter(again)
    for want in stream[3:]:
        got = next(resumed)
        assert torch.equal(got["inputs"], want["inputs"])


def _mk_trainer(tmp_path, steps=8, seed=0, tag="tr", name="qwen2.5-3b"):
    master, client = _port_cloud(tmp_path, chunk_size=64 * 1024)
    cfg = tconfigs.get_config(name).reduced()
    write_synthetic_corpus(client, "c", 300_000, cfg.vocab_size, seed=1)
    ds = SectorTokenDataset(master, client, "c", seq_len=32)
    pcfg = TPC(mesh=None, remat="none")
    pipe = DataPipeline(ds, batch=4, pcfg=pcfg, device="cpu")
    ck = SectorCheckpointer(client, tag)
    tr = Trainer(cfg, pcfg,
                 TrainerConfig(steps=steps, ckpt_every=4, log_every=2,
                               lr=1e-3, seed=seed),
                 pipe, ck, device="cpu")
    return tr, master, client


def test_resume_is_deterministic(tmp_path):
    """run(8) == run(4) + crash + restore + run(4): identical final loss."""
    tr1, *_ = _mk_trainer(tmp_path / "a", steps=8)
    h1 = tr1.run(8)

    tr2, master2, client2 = _mk_trainer(tmp_path / "b", steps=8)
    tr2.run(4)  # checkpoints at step 4 (+cursor)
    ck = SectorCheckpointer(client2, "tr")
    ds = SectorTokenDataset(master2, client2, "c", seq_len=32)
    pipe = DataPipeline(ds, batch=4, pcfg=TPC(mesh=None, remat="none"),
                        device="cpu")
    tr3 = Trainer(tr2.cfg, tr2.pcfg,
                  TrainerConfig(steps=8, ckpt_every=4, log_every=2, lr=1e-3),
                  pipe, ck, device="cpu")
    assert tr3.step_idx == 4  # restored
    for a, b in zip(_flat({"p": tr2.params, "o": tr2.opt}),
                    _flat({"p": tr3.params, "o": tr3.opt})):
        assert torch.equal(a, b)
    h3 = tr3.run(4)
    l1 = [h for h in h1 if h["step"] == 8][0]["loss"]
    l3 = [h for h in h3 if h["step"] == 8][0]["loss"]
    assert abs(l1 - l3) < 1e-3


def test_loss_decreases(tmp_path):
    tr, *_ = _mk_trainer(tmp_path, steps=24)
    hist = tr.run(24)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_trainer_restores_a_jax_checkpoint_and_matches_its_losses(tmp_path):
    """A JAX ``Trainer`` saves its step-0 state through Sector; the port's
    ``Trainer`` restores it from a copy of the two files in its own cloud
    (the shared format); both then train 4 steps on the same corpus
    (float32 reduced qwen2.5-3b) and their loss histories agree."""
    name = "qwen2.5-3b"
    jcfg, tcfg = _cfgs(name)
    jmaster, _, jclient = make_cloud(tmp_path / "j", chunk_size=64 * 1024)
    tmaster, tclient = _port_cloud(tmp_path / "t", chunk_size=64 * 1024)
    j_write_corpus(jclient, "c", 100_000, jcfg.vocab_size, seed=2)
    write_synthetic_corpus(tclient, "c", 100_000, tcfg.vocab_size, seed=2)
    tc_j = JTrainerConfig(steps=4, ckpt_every=100, log_every=1, lr=1e-3,
                          warmup=2)
    tc_t = TrainerConfig(steps=4, ckpt_every=100, log_every=1, lr=1e-3,
                         warmup=2, seed=7)
    jck = JCheckpointer(jclient, "run")
    # float32 params: the JAX init_state's master aliases them, so the
    # JAX step must not donate its arguments
    jtr = JTrainer(jcfg, JPC(mesh=None, remat="none", donate=False), tc_j,
                   JPipeline(JDataset(jmaster, jclient, "c", seq_len=40),
                             batch=2, pcfg=JPC(mesh=None)), jck)
    jtr.save_checkpoint()
    _copy_checkpoint(jclient, tclient, [jck._bin(0), jck._man(0)])
    ttr = Trainer(tcfg, TPC(mesh=None, remat="full"), tc_t,
                  DataPipeline(SectorTokenDataset(tmaster, tclient, "c",
                                                  seq_len=40),
                               batch=2, pcfg=TPC(mesh=None), device="cpu"),
                  SectorCheckpointer(tclient, "run"), device="cpu")
    for (path, want), got in zip(j_flatten(jtr.params), _flat(ttr.params)):
        assert np.array_equal(_np(got), np.asarray(want)), path
    jh, th = jtr.run(4), ttr.run(4)
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [1, 2, 3, 4]
    for a, b in zip(jh, th):
        for k in ("loss", "grad_norm", "lr", "nll"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, err_msg=k)


# ------------------------------------------------------ launcher, limits
def test_launcher_smoke_on_cpu(capsys):
    assert tlaunch.main(["--arch", "recurrentgemma-2b", "--smoke",
                         "--device", "cpu", "--steps", "2", "--batch", "2",
                         "--seq", "16", "--tokens", "20000"]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "device: cpu" in out


@pytest.mark.parametrize("flags", [["--multi-pod"], ["--mode", "podwise"],
                                   ["--compress", "int8_ef"],
                                   ["--compress", "bf16"]])
def test_launcher_mesh_flags_raise(flags, capsys):
    """A mesh flag runs the job on a mesh of ``--ranks`` gloo ranks (one
    here); an unknown value raises."""
    assert tlaunch.main(["--smoke", "--device", "cpu", "--steps", "1",
                         "--batch", "1", "--seq", "8", "--tokens", "5000",
                         *flags]) == 0
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and "mesh: 1 ranks" in out
    with pytest.raises(SystemExit):
        tlaunch.main(["--smoke", "--device", "cpu", flags[0], "ring"]
                     if len(flags) == 2 else [*flags, "--ranks", "x"])


@pytest.mark.parametrize("what", ["podwise", "multi_pod", "int8_ef",
                                  "specs"])
def test_mesh_modes_raise(what, tmp_path):
    """What the mesh step refuses, and what it no longer refuses: the
    podwise step without a mesh with a pod axis raises; microbatch
    accumulation on a mesh that splits the batch builds, the MoE's too
    (once refused, naming ROADMAP item 1.3h).  Without a mesh, an
    ``int8_ef`` state carries ``ef`` and the spec trees are ``P()``."""
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import P
    _, tcfg = _cfgs("qwen2.5-3b")
    ocfg = optim.AdamWConfig()
    lr = optim.warmup_cosine(1e-3, 1, 4)
    grid = Mesh(("data", "model"), {"data": 2, "model": 1}, object(), 0, 2,
                "cpu", "gloo")
    if what == "podwise":
        for mesh in (None, grid):
            with pytest.raises(ValueError, match="pod"):
                tstep.make_train_step(tcfg, TPC(mesh=mesh, mode="podwise",
                                                multi_pod=True), ocfg, lr)
    elif what == "multi_pod":
        step = tstep.make_train_step(tcfg, TPC(mesh=grid, accum_steps=2),
                                     ocfg, lr)
        assert callable(step) and step.specs["embed"]["w"] == P(
            "model", "data")
    elif what == "int8_ef":
        tr, *_ = _mk_trainer(tmp_path)
        tr8 = Trainer(tr.cfg, TPC(mesh=None, compress_pod="int8_ef"),
                      tr.tcfg, tr.pipeline, device="cpu")
        assert set(tr8.opt) == {"step", "m", "v", "master", "ef"}
        assert not any(bool(x.any()) for x in _flat(tr8.opt["ef"]))
        tr8.run(1)
    else:
        _, mcfg = _cfgs("qwen3-moe-30b-a3b")
        step = tstep.make_train_step(mcfg, TPC(mesh=grid), ocfg, lr)
        assert step.specs["blocks"]["layer0"]["moe"]["wi"] == P(
            None, "model", "data", None)
        accum = tstep.make_train_step(mcfg, TPC(mesh=grid, accum_steps=2),
                                      ocfg, lr)
        assert accum.specs == step.specs
        specs = tstep.opt_state_specs_for(tmodel.param_shapes(tcfg),
                                          TPC(mesh=None), ocfg)
        assert specs["step"] == P() and specs["m"]["embed"]["w"] == P()


def test_trainer_default_device_is_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr, *_ = _mk_trainer(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tr.cfg, tr.pcfg, tr.tcfg, tr.pipeline)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataPipeline(tr.pipeline.dataset, batch=2, pcfg=tr.pcfg)
