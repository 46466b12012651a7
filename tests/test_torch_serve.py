"""The port's serving slice on the CPU: ``ServeEngine`` against the JAX
package's, the engine's own contracts, and the launcher.

Both engines serve the same greedy requests with the same parameters
(made by ``repro.models.model.init_params`` and carried across) on the
reduced float32 configs; the token lists must be identical.  The
requests include prompts longer than the window of 64 (so the ring
caches and the window mask carry weight), two slots and more requests
than slots; the encoder-decoder's requests come with frames and without
(zeros, cast to bf16 by both engines), and the vision config serves text
(neither engine splices patches).  The configs held last
(``tests/torch_held.py``) serve the same way: ``gemma3-12b``'s local
layers keep rings of 64 slots that the prompts of 70 and 90 tokens wrap,
``dbrx-132b`` routes each token to 2 of 8 experts (reduced), and the two
variants keep MHA and a head width that is not ``d_model / n_heads``.
Few distinct prompt lengths keep the JAX side's compiles down.

At temperature > 0 the random streams differ on purpose (a
``torch.Generator`` against split ``PRNGKey``s), so the sampler is held
to the JAX package's by its support and its frequencies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import model as jmodel
from repro.serve import SamplerConfig as JSamplerConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.rg_lru_scan import kernel as lkernel
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.serve import SamplerConfig, ServeEngine
from repro_torch.utils.pytree import tree_flatten_with_paths
from torch_held import HELD, reduced


def _f32(cfg):
    return cfg.reduced().replace(param_dtype="float32",
                                 compute_dtype="float32")


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, n)] for n in lengths]


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "qwen2.5-3b",
                                  "xlstm-1.3b", "qwen3-moe-30b-a3b",
                                  "seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"] + HELD)
def test_serve_matches_jax_engine(name):
    jcfg = reduced(ARCHS.__getitem__, name, param_dtype="float32",
                   compute_dtype="float32")
    tcfg = reduced(tconfigs.get_config, name, param_dtype="float32",
                   compute_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _prompts(jcfg.vocab_size, [90, 12, 70, 12, 90])
    max_new, max_len = 6, 128

    jeng = JServeEngine(jcfg, jp, max_batch=2, max_len=max_len,
                        scfg=JSamplerConfig(temperature=0.0))
    jreqs = [jeng.submit(p, max_new=max_new) for p in prompts]
    jeng.run()
    f0, l0 = fkernel.launches, lkernel.launches
    teng = ServeEngine(tcfg, tp, max_batch=2, max_len=max_len,
                       scfg=SamplerConfig(temperature=0.0), device="cpu")
    treqs = [teng.submit(p, max_new=max_new) for p in prompts]
    teng.run()
    assert (fkernel.launches, lkernel.launches) == (f0, l0)
    for tr, jr in zip(treqs, jreqs):
        assert tr.done and jr.done
        assert tr.out == [int(t) for t in jr.out], tr.rid
        assert len(tr.out) == max_new
        assert tr.t_submit <= tr.t_admit <= tr.t_first
    assert all(s is None for s in teng.slot_req)


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (1, n, cfg.d_model)).astype(np.float32)


def test_encdec_frames_match_jax_engine_and_fill_a_prefix():
    """Encoder frames given, one slot: the first request's frames fill
    the cross K / V pool (``max_len`` rows); the second's are fewer and,
    as the JAX engine's ``dynamic_update_slice`` does, overwrite only the
    prefix of the slot's rows, so its decode attends the first request's
    remaining rows (a fault of the reference, ``ROADMAP.md`` §3, which the
    port matches); the third has none (zeros of ``max_len`` rows).  The
    greedy tokens equal the JAX engine's, and after the second admission
    the slot's rows past its frames still hold the first request's."""
    name = "seamless-m4t-large-v2"
    jcfg = _f32(ARCHS[name])
    tcfg = _f32(tconfigs.get_config(name))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    max_len, short = 48, 20
    prompts = _prompts(jcfg.vocab_size, [10, 7, 10], seed=5)
    frames = [_frames(jcfg, max_len, 1), _frames(jcfg, short, 2), None]
    jeng = JServeEngine(jcfg, jp, max_batch=1, max_len=max_len,
                        scfg=JSamplerConfig(temperature=0.0))
    jreqs = [jeng.submit(p, max_new=5, enc_frames=f)
             for p, f in zip(prompts, frames)]
    jeng.run()
    teng = ServeEngine(tcfg, tp, max_batch=1, max_len=max_len,
                       scfg=SamplerConfig(temperature=0.0), device="cpu")
    treqs = [teng.submit(p, max_new=5, enc_frames=f)
             for p, f in zip(prompts, frames)]
    teng.step()
    while teng.slot_req[0] is not None:
        teng.step()
    first = {k: teng.cache["layer0"][k][:, 0].clone() for k in ("xk", "xv")}
    teng._admit()
    with torch.inference_mode():
        _, fresh = tmodel.prefill(tp, {
            "inputs": torch.tensor([prompts[1]], dtype=torch.int32),
            "enc_frames": torch.from_numpy(frames[1]).to(torch.bfloat16)},
            cfg=tcfg, max_len=max_len)
    for k in ("xk", "xv"):
        slot = teng.cache["layer0"][k][:, 0]
        assert torch.equal(slot[:, :short], fresh["layer0"][k][:, 0])
        assert torch.equal(slot[:, short:], first[k][:, short:])
    teng.run()
    for tr, jr in zip(treqs, jreqs):
        assert tr.done and tr.out == [int(t) for t in jr.out], tr.rid


def test_continuous_batching_matches_single_stream():
    """Greedy: each request's output equals its standalone decode."""
    cfg = _f32(tconfigs.get_config("recurrentgemma-2b"))
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts(cfg.vocab_size, [5, 9, 70, 7, 6], seed=2)

    def solo(prompt, n_new=6):
        with torch.inference_mode():
            logits, cache = tmodel.prefill(
                params, {"inputs": torch.tensor([prompt])}, cfg=cfg,
                max_len=96)
            out = [int(torch.argmax(logits[0]))]
            pos = len(prompt)
            for _ in range(n_new - 1):
                lg, cache = tmodel.decode_step(
                    params, cache, torch.tensor([[out[-1]]], dtype=torch.int32),
                    torch.tensor([pos], dtype=torch.int32), cfg=cfg)
                out.append(int(torch.argmax(lg[0])))
                pos += 1
        return out

    want = [solo(p) for p in prompts]
    eng = ServeEngine(cfg, params, max_batch=2, max_len=96,
                      scfg=SamplerConfig(temperature=0.0), device="cpu")
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run()
    for r, w in zip(reqs, want):
        assert r.done
        assert r.out == w, (r.rid, r.out, w)


def test_slot_recycling_and_sampling():
    cfg = tconfigs.get_config("qwen2.5-3b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32,
                      scfg=SamplerConfig(temperature=0.8, top_k=40),
                      device="cpu")
    reqs = [eng.submit([1, 2, 3], max_new=3) for _ in range(6)]
    eng.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 3 for r in reqs)
    assert all(0 <= t < cfg.padded_vocab for r in reqs for t in r.out)
    assert all(s is None for s in eng.slot_req)


def _jax_distribution(logits, scfg):
    """The JAX package's sampling distribution on ``logits`` [B, V]: the
    softmax of its scaled logits, masked by ``lax.top_k``'s k-th value
    (every entry equal to it kept), as ``repro.serve.sampler.sample``
    hands them to ``jax.random.categorical``."""
    lf = jnp.asarray(logits, jnp.float32) / scfg.temperature
    if scfg.top_k:
        kth = jax.lax.top_k(lf, scfg.top_k)[0][..., -1:]
        lf = jnp.where(lf < kth, -1e30, lf)
    return np.asarray(jax.nn.softmax(lf, axis=-1), np.float64)


def test_sampler_at_temperature_matches_the_jax_distribution():
    """``serve/sampler.py::sample`` at temperature 0.8 on fixed logits
    whose k-th values tie (row 0: the 3rd and 4th largest; row 1: the
    2nd to 4th), against the JAX package's sampler: at ``top_k=1`` both
    give the argmax; at ``top_k`` 3 and 0 (the full softmax) the port's
    20,000 draws a row never leave the JAX package's support and their
    frequencies lie within 5 binomial standard errors of its
    probabilities.  The JAX package's own draws (2,000 keys) stay in
    that support too.  The random streams differ on purpose."""
    from repro.serve.sampler import sample as jsample
    from repro_torch.serve.sampler import sample as tsample
    logits = np.array([[2.0, 0.5, 1.25, -1.0, 1.25, 3.0, 0.0, -0.5],
                       [0.25, 1.5, -2.0, 1.5, 2.5, 1.5, 0.0, 1.0]],
                      np.float32)
    B, V = logits.shape
    n = 20_000
    draws = torch.from_numpy(np.repeat(logits, n, axis=0))
    gen = torch.Generator().manual_seed(0)
    keys = jax.random.split(jax.random.PRNGKey(0), 2_000)
    jdraw = jax.jit(jax.vmap(lambda key, scfg=None: jsample(
        jnp.asarray(logits), key, scfg), in_axes=(0, None)),
        static_argnums=1)
    one = SamplerConfig(temperature=0.8, top_k=1)
    got = tsample(draws, gen, one).reshape(B, n)
    assert bool((got == torch.from_numpy(logits.argmax(-1))[:, None]).all())
    assert np.array_equal(np.asarray(jdraw(keys[:50], JSamplerConfig(
        temperature=0.8, top_k=1))), np.broadcast_to(logits.argmax(-1),
                                                     (50, B)))
    for top_k, support in ((3, (4, 4)), (0, (V, V))):
        want = _jax_distribution(logits, JSamplerConfig(temperature=0.8,
                                                        top_k=top_k))
        assert [int((w > 0).sum()) for w in want] == list(support)
        jgot = np.asarray(jdraw(keys, JSamplerConfig(temperature=0.8,
                                                     top_k=top_k)))
        assert all((want[b, jgot[:, b]] > 0).all() for b in range(B))
        got = tsample(draws, gen, SamplerConfig(temperature=0.8,
                                                top_k=top_k))
        assert got.dtype == torch.int32
        freq = np.stack([np.bincount(row, minlength=V) / n
                         for row in got.reshape(B, n).numpy()])
        assert ((freq > 0) <= (want > 0)).all(), (top_k, freq, want)
        se = np.sqrt(want * (1 - want) / n)
        assert (np.abs(freq - want) <= 5 * se).all(), (top_k, freq, want)


def test_launcher_smoke_on_cpu(capsys):
    assert tlaunch.main(["--arch", "recurrentgemma-2b", "--smoke",
                         "--device", "cpu", "--requests", "3",
                         "--max-new", "4"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["xlstm-1.3b", "qwen3-moe-30b-a3b"])
def test_launcher_serves_the_xlstm_and_moe_families(name, capsys):
    """``--arch xlstm-1.3b`` / ``qwen3-moe-30b-a3b`` with ``--smoke
    --device cpu``: the reduced configs, sampled, 3 requests over 4
    slots; the engine's pool holds the float32 recurrent states beside
    the bf16 caches."""
    assert tlaunch.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "4"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_launcher_serves_the_encdec_and_vision_configs(name, capsys):
    """``--arch seamless-m4t-large-v2`` (requests without frames: the
    engine feeds zeros) and ``--arch llava-next-mistral-7b`` (text) with
    ``--smoke --device cpu``: 3 requests over 4 slots."""
    assert tlaunch.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "4"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_slot_pool_overwrites_a_recycled_xlstm_slot():
    """A recycled slot keeps nothing of its last request: each float32
    state leaf and bf16 conv tail of the slot equals a fresh prefill's
    cache for the new prompt."""
    cfg = tconfigs.get_config("xlstm-1.3b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, max_batch=1, max_len=32,
                      scfg=SamplerConfig(temperature=0.0), device="cpu")
    prompts = _prompts(cfg.vocab_size, [9, 5], seed=4)
    eng.submit(prompts[0], max_new=3)
    eng.run()
    eng.submit(prompts[1], max_new=3)
    eng._admit()
    with torch.inference_mode():
        _, want = tmodel.prefill(params, {"inputs": torch.tensor(
            [prompts[1]], dtype=torch.int32)}, cfg=cfg, max_len=32)
    dtypes = set()
    for (path, got), (_, w) in zip(tree_flatten_with_paths(eng.cache),
                                   tree_flatten_with_paths(want)):
        dtypes.add(got.dtype)
        assert torch.equal(got, w), path
    assert dtypes == {torch.float32, torch.bfloat16}


def test_engine_device_rules(monkeypatch):
    cfg = tconfigs.get_config("qwen2.5-3b").reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(cfg, params, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--smoke"])
