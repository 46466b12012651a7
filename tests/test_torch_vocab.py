"""The vocabulary over ``model`` under ``layout="tp"``, on gloo ranks on
the CPU (``torch_train_ranks.vocab_suite``: 4 ranks, the meshes
``(data, model) = (1, 2)`` and ``(1, 4)``), held to one device.

* The vocab-split ``cross_entropy`` on a rank's block of the logits, and
  the head (``copy_to_model``, the block's product) with
  ``cross_entropy`` and ``fused_cross_entropy``, tied and untied: the
  loss, nll, z-loss, accuracy and tokens, and the gradients of the
  logits, ``x`` and the head's block, against the single-device
  functions within ``TOL`` of each one's scale.  The padding lies inside
  the last block (a real vocabulary of 200 of 256) or fills a block of
  ``(1, 4)`` (150 of 256); labels sit on block edges and some are
  ignored; rows hold their maximum at several indices in different
  blocks (ties go to the lowest, as ``argmax`` breaks them).  The bytes
  the cross-entropy hands to the wire follow its row count.
* ``embed_mode="vocab_parallel"`` on a rank's rows of the table equals
  the gather embedding bit for bit, the port's and the JAX package's
  (``transformer.embed`` under ``gather``: its own ``vocab_parallel``
  route aborts the process on the installed jax and is never called
  here), for a tied config with a scaled embedding and an untied one, in
  float32 and bf16; its gradient is the whole table's block.
* A ``tp`` train step on ``(1, 2)``: the gradients of every leaf, tied
  under ``embed_mode="gather"`` (the head on a view of the whole
  table's rows, its gradient and the lookup's on the right rows once)
  with either head, and ``vocab_parallel`` tied and untied, against one
  device's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks
from repro.configs import get_config as jget_config
from repro.models import transformer as jtransformer
from repro.parallel.sharding import ParallelConfig as JPC
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import losses, model, transformer
from repro_torch.parallel.sharding import NO_PARALLEL, ParallelConfig
from repro_torch.train import step as tstep

TOL = 1e-6              # of each quantity's scale, float32
STEP_TOL = 1e-5         # a step's gradient, relative L2 of each leaf


@pytest.fixture(scope="module")
def runs():
    return run_ranks(ranks.vocab_suite, 4, timeout_s=300, join_timeout_s=600)


def _members(runs, shape):
    return [r for r in runs if shape in r]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _metrics(got, loss, m, what):
    _close(got["loss"], float(loss.detach()), what + " loss")
    for k in ("nll", "z_loss"):
        _close(got["metrics"][k], float(m[k].detach()), f"{what} {k}")
    assert got["metrics"]["accuracy"] == float(m["accuracy"]), what
    assert got["metrics"]["tokens"] == float(m["tokens"]), what


def _block(a, index, size, dim):
    n = a.shape[dim] // size
    return np.take(a, range(index * n, (index + 1) * n), axis=dim)


@pytest.mark.parametrize("real", ranks.VOCAB_REAL)
@pytest.mark.parametrize("kind", ranks.VOCAB_DATA)
@pytest.mark.parametrize("shape", ranks.VOCAB_MESHES, ids=str)
def test_cross_entropy_on_a_vocab_block(runs, shape, kind, real):
    """Each rank's ``cross_entropy`` of its block of the logits: the
    metrics of the whole, the gradient of its block; one all-gather of a
    (max, index) pair a row and two sums over ``model`` (the
    exponentials', the gold logits) of a float32 a row."""
    d = ranks.vocab_data(kind)
    logits = torch.from_numpy(d["logits"]).requires_grad_()
    loss, m = losses.cross_entropy(logits, torch.from_numpy(d["labels"]),
                                   real_vocab=real)
    loss.backward()
    rows = ranks.VOCAB_B * ranks.VOCAB_T
    for r in _members(runs, shape):
        got = r[shape]["ce", kind, real]
        _metrics(got, loss, m, f"rank {r['rank']}")
        _close(got["grad"], _block(logits.grad.numpy(), r[shape]["index"],
                                   shape[1], -1), "grad")
        assert got["wire"]["tp_all_reduce"] == 2 * 4 * rows
        assert got["wire"]["all_gather"] == 2 * 4 * rows
        assert got["wire"]["gather"] == 0


@pytest.mark.parametrize("shape", ranks.VOCAB_MESHES, ids=str)
def test_model_argmax_takes_the_lowest_index_of_a_tie(runs, shape):
    d = ranks.vocab_data("exact")
    want = torch.from_numpy(d["logits"]).max(-1)
    for b, t, idx in ranks.VOCAB_TIES:
        assert int(want.indices[b, t]) == min(idx)
    for r in _members(runs, shape):
        got = r[shape]["argmax"]
        np.testing.assert_array_equal(got["max"], want.values.numpy())
        np.testing.assert_array_equal(got["index"],
                                      d["logits"].argmax(-1))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("kind", ranks.VOCAB_DATA)
@pytest.mark.parametrize("shape", ranks.VOCAB_MESHES, ids=str)
def test_head_and_cross_entropy_on_a_vocab_block(runs, shape, kind, tied,
                                                 fused):
    """The head on a rank's block of the vocabulary, then either
    cross-entropy, at both real vocabularies: the whole loss and
    metrics, ``x``'s whole gradient (the ranks' partial ones summed by
    ``copy_to_model``) and the gradient of the rank's block of ``w``."""
    d = ranks.vocab_data(kind, tied)
    labels = torch.from_numpy(d["labels"])
    for real in ranks.VOCAB_REAL:
        x = torch.from_numpy(d["x"]).requires_grad_()
        w = torch.from_numpy(d["w"]).requires_grad_()
        if fused:
            loss, m = losses.fused_cross_entropy(
                x, w, labels, real_vocab=real, transpose_w=tied,
                chunk=ranks.VOCAB_CHUNK)
        else:
            loss, m = losses.cross_entropy(
                losses.head_product(x, w, tied), labels, real_vocab=real)
        loss.backward()
        for r in _members(runs, shape):
            got = r[shape]["head", kind, real, tied, fused]
            what = f"rank {r['rank']} real {real}"
            _metrics(got, loss, m, what)
            _close(got["gx"], x.grad.numpy(), what + " gx")
            _close(got["gw"], _block(w.grad.numpy(), r[shape]["index"],
                                     shape[1], 0 if tied else 1),
                   what + " gw")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ranks.VOCAB_EMBED_ARCHS)
@pytest.mark.parametrize("shape", ranks.VOCAB_MESHES, ids=str)
def test_vocab_parallel_embedding_equals_the_gather(runs, shape, arch,
                                                    dtype):
    """The masked take of each rank's rows summed over ``model`` equals
    the port's and the JAX package's gather embedding bit for bit (the
    table cast to ``dtype``, the scale of a scaled embedding included);
    the gradient of the rank's rows is the whole table's."""
    tcfg = ranks.lm_cfg(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    w = torch.from_numpy(ranks.init_numpy(ranks.lm_cfg(arch))["embed/w"]) \
        .to(getattr(torch, dtype)).requires_grad_()
    toks = torch.tensor(ranks.VOCAB_TOKENS, dtype=torch.int32)
    x = transformer.embed({"embed": {"w": w}}, toks, cfg=tcfg,
                          pcfg=NO_PARALLEL).float()
    (x * torch.from_numpy(ranks.vocab_cotangent(x.shape))).sum().backward()
    jcfg = ranks.reduced(jget_config, arch).replace(param_dtype=dtype,
                                                    compute_dtype=dtype)
    jx = jtransformer.embed({"embed": {"w": jnp.asarray(
        w.detach().float().numpy()).astype(dtype)}}, jnp.asarray(toks.numpy()),
        cfg=jcfg, pcfg=JPC())
    jx = np.asarray(jx.astype(jnp.float32))
    np.testing.assert_array_equal(x.detach().numpy(), jx)
    for r in _members(runs, shape):
        got = r[shape]["embed", arch, dtype]
        np.testing.assert_array_equal(got["x"], x.detach().numpy())
        _close(got["grad"], _block(w.grad.float().numpy(),
                                   r[shape]["index"], shape[1], 0), "grad")


@pytest.mark.parametrize("case", range(len(ranks.VOCAB_STEPS)))
def test_tp_step_gradients_with_the_vocabulary_split(runs, case):
    """A ``tp`` train step on ``(1, 2)`` (``VOCAB_STEPS``): every leaf's
    gradient, gathered whole from the ranks' blocks, within ``STEP_TOL``
    of one device's in relative L2, and the loss within ``TOL``.  The
    head's leaf (``lm_head/w``, or a ``vocab_parallel`` table) is a kept
    ``model`` block; a tied table under ``gather`` is not, and its
    gradient (the lookup's on every row, the head's on the rank's rows)
    is counted once."""
    arch, knobs = ranks.VOCAB_STEPS[case]
    cfg = ranks.lm_cfg(arch)
    params = ranks.nest({k: torch.from_numpy(v) for k, v in
                         ranks.init_numpy(cfg).items()})
    batch = {k: torch.from_numpy(v) for k, v in ranks.lm_batch(cfg).items()}
    (loss, _), grads = tstep._value_and_grad_accum(
        params, batch, cfg=cfg,
        pcfg=ParallelConfig(mesh=None, remat="none", **knobs))
    want = ranks._flat_np(grads)
    vp = knobs.get("embed_mode") == "vocab_parallel"
    kept = {"embed/w"} if vp else set()
    if not cfg.tie_embeddings:
        kept.add("lm_head/w")
    for r in _members(runs, "steps"):
        got = r["steps"][case]
        _close(got["loss"], float(loss), "loss")
        assert kept <= set(got["kept"])
        assert ("embed/w" in got["kept"]) == vp
        assert set(got["grads"]) == set(want)
        for path, g in want.items():
            err = np.linalg.norm(got["grads"][path] - g)
            assert err <= STEP_TOL * np.linalg.norm(g), (path, err)


def test_head_weight_is_a_view_of_a_whole_tied_table():
    """Off the rank's parameters (a whole table kept for the gather
    lookup), the head's weights are a view of its rows of the table;
    a leaf that is already the block is itself."""
    from repro_torch.parallel.mesh_utils import Mesh
    cfg = ranks.lm_cfg("qwen2.5-3b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = params["embed"]["w"]
    for i in range(4):
        mesh = Mesh(("data", "model"), {"data": 1, "model": 4}, object(), i,
                    4, "cpu", "gloo")
        pcfg = ParallelConfig(mesh=mesh)
        head = transformer.head_weight(params, cfg, pcfg)
        assert head.data_ptr() == w[i * 64].data_ptr()
        assert torch.equal(head, w[i * 64:(i + 1) * 64])
        block = {"embed": {"w": w[i * 64:(i + 1) * 64].clone()}}
        assert transformer.head_weight(block, cfg, pcfg) is \
            block["embed"]["w"]
        assert not tstep.tp_leaf("embed/w", cfg, pcfg)
        assert tstep.tp_leaf("embed/w", cfg, pcfg.with_(
            embed_mode="vocab_parallel"))
        assert tstep.tp_leaf("lm_head/w", cfg, pcfg)
        assert not tstep.tp_leaf("lm_head/w", cfg, pcfg.with_(layout="fsdp"))
