"""The port's LM training step on a mesh of gloo ranks on the CPU, held
to the JAX package's sharded step; checkpoints across meshes and
packages; the elastic controller; the launcher's mesh flags.

The ranks start through ``launch.mesh.run_ranks`` and run the bodies in
``torch_train_ranks.py`` (no JAX).  The JAX references run meanwhile in
subprocesses with 4 host devices (the recipe of
``test_spmd_subprocess.py::test_sharded_train_step_matches_single_device``),
from the same arrays: the parameters of the port's ``init_params`` at one
seed, a numpy batch whose rows carry unequal valid-token counts.

(a) The port's 4-rank ``pjit`` step on ``(data, model) = (2, 2)`` against
    the JAX package's ``make_train_step`` on a ``(2, 2)`` host mesh, for
    every dense shipped config (reduced, float32): the loss within 1e-5,
    the gathered updated parameters within ``rtol=2e-4, atol=2e-5`` (the
    bar of the JAX package's podwise test) plus the JAX package's own
    spread under float32 rounding, carried through Adam's first step
    (``_hold`` says how).  ``qwen2.5-3b`` runs both layouts against the JAX step
    at the same layout, ``recurrentgemma-2b`` both against the JAX ``tp``
    step (the JAX step's values do not depend on the layout), and the
    other dense configs ``tp``.  The MoE configs run ``tp`` with the
    ``einsum`` dispatch (token groups, dropped slots and the aux loss over
    the global batch, whose one group of 128 tokens spans every rank) and
    ``fsdp`` with the expert all-to-all (``a2a``), each against the JAX
    step at the same layout and dispatch, the aux loss too.
(b) Podwise ``none`` on ``(pod, data, model) = (2, 2, 1)`` against
    ``pjit`` on the same mesh and the JAX package's single-device step
    (its own podwise mode fails on the installed jax, so it is no
    reference), on a batch whose pods hold equal token counts.  The MoE
    configs' podwise step groups and takes its aux over each pod's rows:
    against the JAX package's single-device gradients of each pod's rows,
    averaged, and its AdamW update of the mean (what its ``pod_body``
    does).
(e) The metrics are the global token-weighted means, the token count
    the global one.
(i) Microbatch accumulation on the mesh (``accum_steps=2``): ``pjit``
    dense and MoE against the JAX package's accumulating step on its host
    mesh, podwise ``none`` against its accumulating ``pod_body``.
(j) The pieces of the per-unit gather: ``sharded.gather_block``'s
    gradient, what a step gathers and hands to the wire (under ``tp`` no
    leaf of a tensor-parallel layer over ``model``; the layers' sums over
    ``model``), and the rows the data pipeline gives each rank under
    accumulation.
(k) The serving mesh (``layout="tp"``) on ``(2, 2)`` and ``(1, 2)``
    against the JAX package's serve steps and ``ServeEngine`` on its host
    mesh, the cache blocks, the sequence-split decode, the
    tensor-parallel collectives, the configs it refuses, the launcher's
    rank body.
(l) A ``tp`` mesh whose ``model`` size divides the LRU width but not the
    RG-LRU gates' 8 blocks (``(1, 3)``, ``lru_width = 48``): each rank
    computes the layer on its slice of the width, its gates from the conv
    output gathered over ``model``; the train step against the JAX
    package's step on its host mesh, the serve steps and engine against
    its serve steps and engine.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_train_ranks as ranks
from repro.train import SectorCheckpointer as JCheckpointer
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")
LOSS_TOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
GRAD_TOL = 1e-4         # the gradients, of each leaf's norm
EPS = 1e-8              # AdamWConfig.eps of both packages


def _adam_reach(m, d):
    """How far apart AdamW's first step can put an element whose first
    moment (0.1 x the clipped gradient) lies anywhere in ``[m - d, m +
    d]``, in units of the learning rate: the step is ``lr * f(10 m)``
    (bias-corrected moments) with ``f(x) = x / (|x| + eps)``, increasing
    in ``m``.  Where ``d`` is well below ``|m|`` this is ~0: the step
    keeps the gradient's sign whatever its rounding.  Where ``d`` spans
    zero it reaches 2: the sign is float32 noise, and two summation
    orders move the element in opposite directions."""
    def f(x):
        return x / (np.abs(x) + EPS)
    return f(10 * (m + d)) - f(10 * (m - d))


_JAX = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS
from repro.launch.mesh import make_mesh_compat
from repro.models import model
from repro.parallel.sharding import ParallelConfig
from repro.train import optim
from repro.train.step import _value_and_grad_accum, make_train_step
from repro.utils.pytree import tree_flatten_with_paths
import torch_train_ranks as R

def use_mesh(mesh):
    return jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh

def pod_means(cfg, ocfg, lr_fn, pods, accum):
    # each pod's rows on one device (accumulated over its microbatches),
    # the gradients and metrics averaged over the pods, one AdamW update
    # of the mean (the pod_body's values)
    pcfg = ParallelConfig(mesh=None, remat="none", accum_steps=accum)

    def step(params, opt, batch):
        n = batch["inputs"].shape[0] // pods
        outs = [_value_and_grad_accum(
            params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()},
            cfg=cfg, pcfg=pcfg) for i in range(pods)]
        mean = lambda *xs: sum(xs) / pods
        (loss, metrics), grads = jax.tree.map(mean, *outs)
        p2, o2, om = optim.apply_updates(params, grads, opt, ocfg, lr_fn)
        return p2, o2, {**metrics, **om, "loss": loss}
    return step

def run(arch, layout, mesh, masked):
    # layout: "tp", "fsdp/a2a", "pods", ..., "@2" accumulating 2
    # microbatches
    layout, _, accum = layout.partition("@")
    accum = int(accum or 1)
    tcfg = R.lm_cfg(arch)
    cfg = R.reduced(ARCHS.__getitem__, arch).replace(
        param_dtype="float32", compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, R.nest(R.init_numpy(tcfg)))
    batch = {k: jnp.asarray(v)
             for k, v in R.lm_batch(tcfg, masked=masked).items()}
    ocfg = optim.AdamWConfig(lr=R.LR)
    opt = optim.init_state(params, ocfg)
    lr_fn = optim.warmup_cosine(R.LR, R.WARMUP, R.TOTAL)
    if layout == "pods":
        step = pod_means(cfg, ocfg, lr_fn, 2, accum)
    else:
        layout, _, dispatch = layout.partition("/")
        pcfg = ParallelConfig(mesh=mesh, remat="none", layout=layout,
                              moe_dispatch=dispatch or "einsum",
                              accum_steps=accum)
        step = make_train_step(cfg, pcfg, ocfg, lr_fn)
    # the same step with the embedding one ulp off (signs from four
    # seeds): how far the JAX package's own step moves under float32
    # rounding
    emb = np.asarray(params["embed"]["w"])

    def ulp(seed):
        sign = np.where(np.random.default_rng(seed).random(emb.shape) < 0.5,
                        -1, 1)
        return {**params, "embed": {**params["embed"], "w": jnp.asarray(
            emb * (1 + 2.0 ** -23 * sign), jnp.float32)}}
    fn = jax.jit(step)
    out = {}
    for tag, p in [("", params)] + [(t, ulp(i)) for i, t in enumerate("uvwx")]:
        if mesh is None:
            p2, o2, m = fn(p, opt, batch)
        else:
            with use_mesh(mesh):
                p2, o2, m = fn(p, opt, batch)
        out.update({f"{tag}m/{k}": np.asarray(v) for k, v in m.items()})
        out.update({f"{tag}p/{q}": np.asarray(x)
                    for q, x in tree_flatten_with_paths(p2)})
        out.update({f"{tag}g/{q}": np.asarray(x)
                    for q, x in tree_flatten_with_paths(o2["m"])})
    return out

def serve(arch, mesh):
    # the serve steps and the engine on the host mesh, greedy
    from repro.serve import SamplerConfig, ServeEngine
    from repro.train.step import make_prefill_step, make_serve_step
    tcfg = R.serve_cfg(arch)
    cfg = R.reduced(ARCHS.__getitem__, arch).replace(
        param_dtype="float32", compute_dtype="float32",
        n_layers=tcfg.n_layers)
    params = jax.tree.map(jnp.asarray, R.nest(R.init_numpy(tcfg)))
    pcfg = ParallelConfig(mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in R.serve_inputs(tcfg).items()}
    toks = batch["inputs"]
    pos = jnp.full((R.SERVE_B,), R.SERVE_T, jnp.int32)
    with use_mesh(mesh):
        logits, cache = jax.jit(make_prefill_step(cfg, pcfg, R.SERVE_LEN))(
            params, batch)
        nxt, _ = jax.jit(make_serve_step(cfg, pcfg))(params, cache,
                                                     toks[:, -1:], pos)
    cache = jax.tree.map(np.asarray, cache)
    # the engine off the mesh (its values are the mesh's; its programs
    # compile in two thirds of the time), its decode step from the
    # prefill's cache (the pool's shapes: SERVE_B = SERVE_SLOTS)
    eng = ServeEngine(cfg, params, max_batch=R.SERVE_SLOTS,
                      max_len=R.SERVE_LEN, scfg=SamplerConfig())
    dec, _ = eng._decode(params, cache, toks[:, -1:], pos)
    reqs = [eng.submit(p, max_new=R.SERVE_NEW, enc_frames=f) for p, f in
            zip(R.serve_prompts(tcfg), R.serve_request_frames(tcfg))]
    eng.run()
    out = {"prefill": np.asarray(logits), "decode": np.asarray(dec),
           "next": np.asarray(nxt), "tokens": np.asarray([r.out
                                                         for r in reqs])}
    out.update({f"cache/{q}": np.asarray(x)
                for q, x in tree_flatten_with_paths(cache)})
    return out

cases, dest = eval(sys.argv[1]), sys.argv[2]
mesh = make_mesh_compat((2, 2), ("data", "model"))
# three of the four host devices, (data, model) = (1, 3)
trio = jax.sharding.Mesh(np.array(jax.devices()[:3]).reshape(1, 3),
                         ("data", "model"))
res = {}
for arch, layout in cases:
    if layout == "serve":
        got = serve(arch, mesh)
    elif layout == "serve13":
        got = serve(arch, trio)
    elif layout.partition("@")[0] in ("single", "pods"):
        got = run(arch, "tp" if layout == "single" else layout, None,
                  R.POD_MASKED)
    else:
        got = run(arch, layout, mesh, ((1, 5), (6, 11)))
    res.update({f"{arch}|{layout}|{k}": v for k, v in got.items()})
np.savez(dest, **res)
"""

# the accumulating cases' JAX layouts ("@2": two microbatches)
_ACCUM = {(a, lay): f"{lay}/{d}@{ranks.ACCUM}" if a in ranks.MOE_ARCHS
          else f"{lay}@{ranks.ACCUM}" for a, lay, d in ranks.ACCUM_CASES}
_POD_ACCUM = f"pods@{ranks.ACCUM}"
# the JAX cases, split over subprocesses that run side by side
_JAX_SPLIT = (
    [("recurrentgemma-2b", "tp")]
    + [k[:1] + (v,) for k, v in _ACCUM.items() if k[0] == "qwen2.5-3b"]
    + [(ranks.PODWISE_ARCH, _POD_ACCUM), ("qwen2.5-3b", "serve"),
       ("xlstm-1.3b", "serve")],
    [("xlstm-1.3b", "tp"), ("qwen2.5-3b", "tp"), ("qwen2.5-3b", "fsdp"),
     ("recurrentgemma-2b", "serve"), (ranks.LRU_SPLIT, "tp"),
     (ranks.LRU_SPLIT, "serve"), (ranks.HEADS_WHOLE, "serve13"),
     (ranks.RING_WHOLE, "serve13")],
    [(a, "tp") for a in ("gemma3-12b", "qwen3-8b", "deepseek-7b",
                         "llava-next-mistral-7b", "seamless-m4t-large-v2")]
    + [(ranks.PODWISE_ARCH, "single"), ("gemma3-12b", "serve"),
       ("seamless-m4t-large-v2", "serve")],
    [(a, lay) for a in ranks.MOE_ARCHS
     for lay in ("tp/einsum", "fsdp/a2a", "pods")]
    + [k[:1] + (v,) for k, v in _ACCUM.items() if k[0] in ranks.MOE_ARCHS]
    + [("qwen3-moe-30b-a3b", "serve")],
)


def _start_jax(cases, dest):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.dirname(__file__)])
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), repr(cases), dest],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's rank-0 results, the JAX references), computed side by
    side."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    procs = [(_start_jax(c, str(tmp / f"jax{i}.npz")), tmp / f"jax{i}.npz")
             for i, c in enumerate(_JAX_SPLIT)]
    try:
        port = run_ranks(ranks.mesh_train_suite, 4, timeout_s=300,
                         join_timeout_s=600)[0]
    finally:
        outs = [(p.communicate(timeout=600), dest) for p, dest in procs]
    ref = {}
    for ((_, err), dest), (p, _) in zip(outs, procs):
        assert p.returncode == 0, err[-3000:]
        ref.update(dict(np.load(dest)))
    return port, ref


def _ref(ref, arch, layout, tag=""):
    pre = f"{arch}|{layout}|{tag}"

    def part(kind):
        return {k[len(pre) + 2:]: v for k, v in ref.items()
                if k.startswith(pre + kind + "/")}
    return ({k: float(v) for k, v in part("m").items()}, part("p"),
            part("g"))


def _hold(got, want, ulps=(), tokens=True):
    """The loss and metrics; the first moments ``m`` (0.1 x the clipped
    gradient) within ``GRAD_TOL`` of each leaf's norm (in norm); every
    updated parameter within ``ATOL + RTOL * |p|`` (the bar of the JAX
    package's podwise test), plus three times what the JAX package's own
    step moves it when its embedding moves by one ulp (``ulps``, the JAX
    steps from there, four draws of the signs; the largest), plus the
    learning rate times :func:`_adam_reach` of the JAX package's ``m``
    and three times its own spread over those draws.  All of it is read
    off the JAX package's runs, none off the port's.  The ulp spread is
    ~1e-7 of most configs' outputs and ~1e-3 of the xLSTM stack's at
    random weights (the rule of ``test_torch_train.py``'s xLSTM tests);
    the reach is ~0 except where the JAX package's own gradient changes
    sign under that rounding (up to 100 elements of a reduced dense
    config, 28,864 of the xLSTM's 542,256)."""
    (gm, gp, gg), (wm, wp, wg) = got, want
    ulps = ulps or (want,)

    def spread(i, key):
        return 3 * np.max([np.abs(np.asarray(u[i][key], np.float64)
                                  - want[i][key]) for u in ulps], axis=0)

    for k in ("loss", "nll", "z_loss", "accuracy"):
        tol = LOSS_TOL * max(1.0, abs(wm[k])) + spread(0, k)
        assert abs(gm[k] - wm[k]) <= tol, (k, gm[k], wm[k])
    assert gm["tokens"] == wm["tokens"] or not tokens
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"],
                               rtol=1e-4 + spread(0, "grad_norm")
                               / wm["grad_norm"])
    assert set(gp) == set(wp) == set(gg) == set(wg)
    for path in wp:
        w = np.asarray(wg[path], np.float64)
        assert np.linalg.norm(gg[path] - w) <= GRAD_TOL * np.linalg.norm(w) \
            + 3 * max(np.linalg.norm(u[2][path] - w) for u in ulps), path
        err = np.abs(gp[path] - wp[path])
        bar = ATOL + RTOL * np.abs(wp[path]) + spread(1, path) \
            + wm["lr"] * _adam_reach(w, spread(2, path))
        assert np.all(err <= bar), (path, int((err > bar).sum()),
                                    float((err / bar).max()))


@pytest.mark.parametrize("arch,layout", [
    (a, lay) for a, lays in ranks.PJIT_CASES.items() for lay in lays])
def test_pjit_step_matches_jax_host_mesh(runs, arch, layout):
    port, ref = runs
    at = layout if (arch, layout) in _JAX_SPLIT[1] else "tp"
    _hold(port["pjit"][arch, layout], _ref(ref, arch, at),
          [_ref(ref, arch, at, t) for t in "uvwx"])


def test_token_weighted_global_metrics(runs):
    """(e): rows 1 and 6 carry 11 and 5 valid tokens of 16, on different
    data ranks: the loss is the mean over the global valid tokens, not a
    mean of the ranks' means (which differs here)."""
    port, ref = runs
    m = port["pjit"]["qwen2.5-3b", "tp"][0]
    assert m["tokens"] == ranks.B * ranks.T - 5 - 11
    wm = _ref(ref, "qwen2.5-3b", "tp")[0]
    assert abs(m["nll"] - wm["nll"]) <= LOSS_TOL


def _hold_moe(got, want, ulps, tokens=True):
    """``_hold``, and the aux loss within ``LOSS_TOL`` (it is in the
    loss, which ``_hold`` holds; here it is held apart)."""
    _hold(got, want, ulps, tokens=tokens)
    assert got[0]["aux_loss"] > 0
    assert abs(got[0]["aux_loss"] - want[0]["aux_loss"]) \
        <= LOSS_TOL * abs(want[0]["aux_loss"])


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
def test_moe_on_a_batch_splitting_mesh_names_its_item(runs, arch):
    """The MoE step on the ``(2, 2)`` mesh under ``tp`` with the
    ``einsum`` dispatch, whose token group (the global batch's 128
    tokens) spans both data ranks, against the JAX package's step there
    (once refused, naming ROADMAP item 1.3g)."""
    port, ref = runs
    at = "tp/einsum"
    _hold_moe(port["moe"][arch, "tp"], _ref(ref, arch, at),
              [_ref(ref, arch, at, t) for t in "uvwx"])


def test_moe_a2a_under_fsdp_names_its_item(runs):
    """Both MoE configs' step on the ``(2, 2)`` mesh under ``fsdp`` with
    the expert all-to-all over ``model`` (``moe_dispatch="a2a"``: each
    rank routes its 32 tokens, 4 experts a ``model`` rank), against the
    JAX package's step with its ``_apply_a2a`` on the same host mesh
    (once refused, naming ROADMAP item 1.3g)."""
    port, ref = runs
    at = "fsdp/a2a"
    for arch in ranks.MOE_ARCHS:
        _hold_moe(port["moe"][arch, "fsdp"], _ref(ref, arch, at),
                  [_ref(ref, arch, at, t) for t in "uvwx"])


@pytest.mark.parametrize("layout", [lay for lay, _ in ranks.MOE_STEPS])
def test_moe_step_under_full_remat(runs, layout):
    """The MoE step under ``remat="full"``, whose backward recomputes
    each unit's forward with its collectives (the ids' all-gather, the
    aux statistics', the expert all-to-all) between the ranks' backward
    collectives: it completes on every rank and gives the step without
    remat's values, bit for bit."""
    port, _ = runs
    arch = ranks.MOE_ARCHS[0]
    (gm, gp, gg), (wm, wp, wg) = port["moe_remat"][layout], \
        port["moe"][arch, layout]
    assert gm == wm
    for got, want in ((gp, wp), (gg, wg)):
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ranks.MOE_ARCHS)
def test_moe_podwise_none_matches_pod_means(runs, arch):
    """(b) for the MoE: podwise ``none`` on ``(pod, data, model) = (2, 2,
    1)``, each pod's token groups and aux loss over its own 4 rows (split
    over its 2 data ranks), against the JAX package's single-device
    gradients of each pod's rows averaged and its update of the mean."""
    port, ref = runs
    _hold_moe(port["pod_moe"][arch], _ref(ref, arch, "pods"),
              [_ref(ref, arch, "pods", t) for t in "uvwx"])


def test_podwise_none_matches_pjit_and_single_device(runs):
    port, ref = runs
    pod, pj = port["pod"]["podwise"], port["pod"]["pjit"]
    want = _ref(ref, ranks.PODWISE_ARCH, "single")
    ulps = [_ref(ref, ranks.PODWISE_ARCH, "single", t) for t in "uvwx"]
    _hold(pj, want, ulps)
    _hold(pod, want, ulps, tokens=False)
    assert pod[0]["tokens"] * 2 == pj[0]["tokens"]    # the pods' mean
    _hold(pod, pj, tokens=False)


# ------------------------------------------------------------ (i), (j)
@pytest.mark.parametrize("arch,layout",
                         [(a, lay) for a, lay, _ in ranks.ACCUM_CASES])
def test_accumulated_pjit_step_matches_jax_host_mesh(runs, arch, layout):
    """(i) The ``pjit`` step with ``accum_steps=2`` on the ``(2, 2)`` gloo
    mesh against the JAX package's ``make_train_step`` with
    ``accum_steps=2`` on its ``(2, 2)`` host mesh: each rank runs its
    rows of each global microbatch in turn, weighted by its share of that
    microbatch's 59 or 53 valid tokens, and the MoE groups and takes its
    aux loss over each global microbatch (``tp`` / ``einsum``, ``fsdp`` /
    ``a2a``).  The per-microbatch means make a loss other than the
    unaccumulated step's."""
    port, ref = runs
    at = _ACCUM[arch, layout]
    hold = _hold_moe if arch in ranks.MOE_ARCHS else _hold
    got = port["accum"][arch, layout]
    hold(got, _ref(ref, arch, at), [_ref(ref, arch, at, t) for t in "uvwx"])
    assert got[0]["tokens"] == (ranks.B * ranks.T - 5 - 11) / ranks.ACCUM
    if arch == "qwen2.5-3b":
        assert got[0]["nll"] != port["pjit"][arch, layout][0]["nll"]


def test_podwise_none_accumulates_as_pod_body(runs):
    """(i) Podwise ``none`` with ``accum_steps=2`` on ``(pod, data,
    model) = (2, 2, 1)``: each pod's rows split into two microbatches of
    2 rows (27 and 32 valid tokens in pod 0), one row a data rank, against
    the JAX package's single-device accumulated gradients of each pod's
    rows, averaged over the pods, and its update of the mean."""
    port, ref = runs
    want = _ref(ref, ranks.PODWISE_ARCH, _POD_ACCUM)
    _hold(port["pod"]["podwise_accum"], want,
          [_ref(ref, ranks.PODWISE_ARCH, _POD_ACCUM, t) for t in "uvwx"])


def _tp_split(path: str, cfg, kw: dict, m: int = 2) -> bool:
    """Whether a ``tp`` step's layer computes on its ``model`` block of
    the leaf at ``path``: a stack's attention where the JAX package's
    ``heads_spec`` splits the heads (``wk`` / ``wv`` where the kv heads
    split too), its dense FFN where ``model`` divides ``d_ff``, its RG-LRU
    block where it divides the LRU width (``gate_a`` / ``gate_x``
    excepted: their spec splits every block's columns), its mLSTM's and
    sLSTM's leaves where it divides the heads (``up``, the gates and
    ``r_*`` excepted: their specs split other columns), its MoE's experts
    where it divides their count; the head's columns (``lm_head/w``), and
    a ``vocab_parallel`` table's rows, where it divides the padded
    vocabulary; the frontends' ``w1`` where it divides ``d_model``."""
    if kw.get("layout", "tp") != "tp":
        return False
    vocab = cfg.padded_vocab % m == 0
    if path == "lm_head/w":
        return vocab
    if path == "embed/w":
        return vocab and kw.get("embed_mode") == "vocab_parallel"
    if path == "frontend/w1":
        return cfg.d_model % m == 0
    if "blocks/" not in path:
        return False
    layer, leaf = path.split("/")[-2:]
    heads = cfg.n_heads % m == 0
    if layer == "attn":
        return heads and (leaf in ("wq", "bq", "wo")
                          or cfg.n_kv_heads % m == 0)
    if layer == "mlp":
        return cfg.d_ff % m == 0
    if layer == "rglru":
        return leaf in ("in_x", "in_g", "conv_w", "a_param", "out") \
            and cfg.lru_width % m == 0
    if "/mlstm/" in path:
        return heads and (leaf in ("conv_w", "out_norm", "down")
                          or layer in ("q", "k", "v"))
    if layer == "slstm":
        return heads and leaf[:2] in ("w_", "b_")
    if layer == "moe":
        return leaf != "router" and cfg.n_experts % m == 0
    return False


def _expected_tp_bytes(arch: str, kw: dict) -> int:
    """The bytes a rank of a ``tp`` step on the ``(2, 2)`` mesh should
    hand to the tensor-parallel sums (float32): each layer computed on a
    ``model`` block sums its output ``[rows, T, d]`` over ``model`` in the
    forward (again in the recompute under full remat) and its input's
    gradient in the backward; the replicated leaves inside such a layer
    (the qk-norm scales, ``wk`` / ``wv`` where the kv heads do not
    split, the RG-LRU gates, the MoE's float32 router) sum their
    gradients.  Where ``model`` divides the padded vocabulary the head
    computes the rank's block of the logits: its input's gradient is
    summed over ``model``, and the cross-entropy sums each row's
    exponentials and its gold logit (a float32 each)."""
    cfg = ranks.lm_cfg(arch)
    if kw.get("layout", "tp") != "tp":
        return 0
    m, accum = 2, kw.get("accum_steps", 1)
    tokens = ranks.B // 2 // accum * ranks.T
    act = tokens * cfg.d_model
    head = act + 2 * tokens if cfg.padded_vocab % m == 0 else 0
    passes = (2 if kw.get("remat") == "full" else 1) + 1
    n = 0
    for sym in cfg.block_pattern:
        if sym in "AL" and cfg.n_heads % m == 0:
            n += act * passes + 2 * cfg.d_head * cfg.qk_norm
            if cfg.n_kv_heads % m:
                n += 2 * cfg.kv_dim * (cfg.d_model + cfg.qkv_bias)
        if sym == "R" and cfg.lru_width % m == 0:
            n += act * passes + 2 * cfg.lru_width ** 2 // 8
        if sym in "ALR" and cfg.family != "moe" and cfg.d_ff % m == 0:
            n += act * passes
        if sym in "AL" and cfg.family == "moe" and cfg.n_experts % m == 0:
            n += act * passes + cfg.d_model * cfg.n_experts
    # under full remat the recompute stops once the backward's saved
    # tensors are remade: a unit ending in a split FFN skips its last sum
    split_ffn = cfg.n_experts % m == 0 if cfg.family == "moe" \
        else cfg.d_ff % m == 0
    if kw.get("remat") == "full" and split_ffn:
        n -= act
    return 4 * (n * cfg.n_groups + head) * accum


def _expected_gathers(arch: str, kw: dict):
    """(the whole shapes the step's gathers should make, the bytes this
    rank should hand to them) on the ``(2, 2)`` mesh, from the leaf
    shapes and specs: every leaf split over more than one rank once a
    microbatch, a stacked leaf's unit (never the stacked leaf) in each
    of its groups, twice under ``remat="full"``; an expert stack under
    ``fsdp`` / ``a2a`` only over ``data``, each rank keeping its experts'
    block along ``model``, and under ``tp`` the leaves a layer computes
    on its ``model`` block (:func:`_tp_split`) likewise: none of them is
    gathered over ``model``."""
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    from repro_torch.parallel.sharding import param_specs_for
    from repro_torch.utils.pytree import tree_flatten_with_paths as flat
    sizes = {"data": 2, "model": 2}
    mesh = Mesh(("data", "model"), sizes, object(), 0, 4, "cpu", "gloo")
    cfg = ranks.lm_cfg(arch)
    shapes = tmodel.param_shapes(cfg)
    specs = dict(flat(param_specs_for(shapes, TPC(mesh=mesh, **kw))))
    a2a = kw.get("moe_dispatch") == "a2a" and kw.get("layout") == "fsdp"
    reps = kw.get("accum_steps", 1)
    out, nbytes = [], 0
    for path, leaf in flat(shapes):
        shape = list(leaf.shape)
        numel = int(np.prod(shape))
        gathered = False
        for d, axis in enumerate(specs[path]):
            if axis is None:
                continue
            numel //= sizes[axis]
            if axis == "model" and (a2a and "/moe/w" in path
                                    or _tp_split(path, cfg, kw)):
                shape[d] //= sizes[axis]
            else:
                gathered = True
        if not gathered:
            continue
        nbytes += numel * 4 * reps
        if "blocks/" in path:
            unit = 2 if kw.get("remat") == "full" else 1
            out += [tuple(shape[1:])] * (shape[0] * unit * reps)
            nbytes += numel * 4 * reps * (unit - 1)
        else:
            out += [tuple(shape)] * reps
    return out, nbytes, {tuple(s.shape) for p, s in flat(shapes)
                         if "blocks/" in p}


_LOGGED = {("moe_remat", lay): (ranks.MOE_ARCHS[0], {
    "layout": lay, "moe_dispatch": d, "remat": "full"})
    for lay, d in ranks.MOE_STEPS}
_LOGGED.update({("accum", a, lay): (a, {
    "layout": lay, "moe_dispatch": d, "accum_steps": ranks.ACCUM})
    for a, lay, d in ranks.ACCUM_CASES})
_LOGGED.update({("pjit", a): (a, {"layout": "tp"}) for a in ranks.TP_LOGGED})


@pytest.mark.parametrize("key", list(_LOGGED), ids=str)
def test_step_gathers_each_unit_not_the_stack(runs, key):
    """(j) A train step's gathers, recorded on rank 0: each leaf outside
    the stack once a microbatch, each pattern unit inside its remat
    wrapper (twice under full remat: the recompute gathers it again),
    never a whole ``[n_groups, ...]`` stacked leaf, under ``fsdp`` /
    ``a2a`` the experts only over ``data``, and under ``tp`` no leaf of an
    attention, dense-FFN or RG-LRU layer over ``model`` where the JAX
    activation specs split its width, nor an MoE's experts where
    ``model`` divides them (each ``model`` block, E / 2 experts of the
    MoE's, is gathered over ``data`` alone); ``WIRE["gather"]`` is the
    bytes of those
    blocks, ``WIRE["tp_all_reduce"]`` those of the layers' sums over
    ``model`` (:func:`_expected_tp_bytes`)."""
    port, _ = runs
    log = port["logs"][key]
    arch, kw = _LOGGED[key]
    shapes, nbytes, stacked = _expected_gathers(arch, kw)
    assert not stacked & set(log["shapes"])
    assert sorted(log["shapes"]) == sorted(shapes)
    assert log["wire"]["gather"] == nbytes
    assert log["wire"]["reduce_scatter"] > 0
    assert log["wire"]["tp_all_reduce"] == _expected_tp_bytes(arch, kw)


@pytest.mark.parametrize("case", range(len(ranks.GATHER_CASES)))
def test_gather_block_gradient_is_the_reduce_scatter(runs, case):
    """(j) ``sharded.gather_block`` on rank 0 of the ``(2, 2)`` gloo
    mesh: the whole leaf (its experts' block where ``model`` is kept);
    the gradient of its block equals ``reduce_scatter_leaf`` of the
    whole cotangent, and the sum of the cotangents of the ranks it sums
    over, cut to the block."""
    port, _ = runs
    got = port["gather_block"][case]
    assert got["forward"]
    assert got["grad"].shape == got["block"]
    np.testing.assert_array_equal(got["grad"], got["rs"])
    np.testing.assert_allclose(got["grad"], got["truth"], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["pjit", "fsdp", "podwise"])
def test_pipeline_rows_follow_the_microbatches(mode, tmp_path):
    """(j) ``DataPipeline``'s rows on each rank of a 4-rank mesh with
    ``accum_steps=2`` equal ``step.local_batch``'s of the same global
    batch; concatenated over the ranks, microbatch by microbatch (the
    pods first under podwise), they are the global batch in the JAX
    package's microbatch order.  A microbatch that does not split over
    the ranks raises."""
    import torch

    from repro_torch.data import (DataPipeline, SectorTokenDataset,
                                  write_synthetic_corpus)
    from repro_torch.data.dataset import Cursor
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    from repro_torch.train import step as tstep
    from torch_mesh_ranks import cloud
    master, client = cloud(tmp_path, chunk_records=640)
    write_synthetic_corpus(client, "c", 20_000, 512, seed=1)
    ds = SectorTokenDataset(master, client, "c", seq_len=8)
    axes, shape, kw = {
        "pjit": (("data", "model"), (4, 1), {}),
        "fsdp": (("data", "model"), (2, 2), {"layout": "fsdp"}),
        "podwise": (("pod", "data", "model"), (2, 2, 1),
                    {"multi_pod": True, "mode": "podwise"})}[mode]
    rows = []
    for r in range(4):
        mesh = Mesh(axes, dict(zip(axes, shape)), object(), r, 4, "cpu",
                    "gloo")
        pcfg = TPC(mesh=mesh, accum_steps=2, **kw)
        got = next(iter(DataPipeline(ds, batch=16, pcfg=pcfg,
                                     device="cpu")))
        host, _ = next(ds.batches(16, Cursor()))
        want = tstep.local_batch({k: torch.from_numpy(v)
                                  for k, v in host.items()}, pcfg)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)
        rows.append(got["inputs"].numpy())
        with pytest.raises(ValueError, match="rows"):
            tstep.local_batch({"inputs": torch.zeros(12, 8)}, pcfg)
    # global microbatch i of the JAX package's scan: rows [2i, 2i + 2)
    # of each rank's 4 in rank order (the pod's rows of microbatch i
    # of its pod's 8 under podwise)
    if mode == "podwise":
        order = [np.concatenate([rows[2 * p + d][2 * i:2 * i + 2]
                                 for d in range(2)])
                 for p in range(2) for i in range(2)]
    else:
        order = [np.concatenate([x[2 * i:2 * i + 2] for x in rows])
                 for i in range(2)]
    np.testing.assert_array_equal(np.concatenate(order), host["inputs"])


# ------------------------------------------------------------ (k) serving
SERVE_TOL = 1e-4        # the logits, of the JAX package's largest |logit|


def _serve_ref(ref, arch, layout="serve"):
    pre = f"{arch}|{layout}|"
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


@pytest.mark.parametrize("arch,shape", ranks.SERVE_CASES, ids=str)
def test_serving_mesh_matches_jax_host_mesh(runs, arch, shape):
    """(k) The serve steps on the gloo mesh (``layout="tp"``), rank 0,
    against the JAX package's ``make_prefill_step`` / ``make_serve_step``
    and its ``decode_step`` jitted on its ``(2, 2)`` host mesh, float32:
    the prefill's last logits of 4 prompts of 80 tokens (past the window
    of 64: ring caches; ``qwen2.5-3b`` also on ``(1, 4)``, whose 2 kv
    heads do not split over 4) and one decode step's logits within
    ``SERVE_TOL`` of the scale, its greedy tokens equal; and the
    ``ServeEngine``'s greedy token streams of 6 requests over 4 slots
    equal to the JAX ``ServeEngine``'s (off its mesh: the same values).
    The serve steps gather no weight (``serve_params`` gathered them
    once).  The configs are cut to one pattern unit
    (``torch_train_ranks.serve_cfg``).  ``qwen3-moe-30b-a3b`` serves its 8
    experts 4 a ``model`` rank, ``seamless-m4t-large-v2`` its encoder,
    decoder and cross blocks on 2 of 4 heads a rank from the frames of
    ``serve_inputs`` / ``serve_request_frames`` (requests of 40 frames
    write only their prefix of a recycled slot's 96 cross rows, in both
    engines, the frames projected on a rank's columns), ``xlstm-1.3b`` its
    mLSTM and sLSTM on 2 of 4 heads a rank."""
    port, ref = runs
    got, want = port["serve"][arch, shape], _serve_ref(ref, arch)
    for key in ("prefill", "decode"):
        scale = np.abs(want[key]).max()
        assert got[key].shape == want[key].shape, key
        assert np.abs(got[key] - want[key]).max() <= SERVE_TOL * scale, key
    np.testing.assert_array_equal(got["next"], want["next"])
    assert got["tokens"] == want["tokens"].tolist()
    # the serve steps gather no weight; the layers on a model block sum
    # over model
    assert got["wire"]["gather"] == 0
    assert got["wire"]["tp_all_reduce"] > 0


@pytest.mark.parametrize("arch,shape", ranks.SERVE_CASES, ids=str)
def test_serving_cache_blocks_follow_cache_specs(runs, arch, shape):
    """(k) Rank 0's block of the prefill's cache is the JAX package's
    cache cut by ``cache_specs_for`` (``convert.cache_from_jax`` onto the
    rank's blocks): its kv heads over ``model`` (``qwen2.5-3b``, and
    ``gemma3-12b``, whose ring ``kpos`` splits over the sequence), or its
    block of the sequence (``recurrentgemma-2b``'s one kv head,
    ``qwen2.5-3b``'s two on ``(1, 4)``), the
    RG-LRU state by width, the cross caches ``xk`` / ``xv`` by kv heads,
    the mLSTM's states by heads (its conv window by features) and the
    sLSTM's by features; and the engine's pool holds its blocks of a
    4-slot cache (an encoder-decoder's cross rows ``SERVE_LEN``)."""
    from repro_torch.convert import cache_from_jax
    from repro_torch.models import model as tmodel
    from repro_torch.parallel import sharded
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths as flat
    got = runs[0]["serve"][arch, shape]
    mesh = Mesh(("data", "model"), dict(zip(("data", "model"), shape)),
                object(), 0, shape[0] * shape[1], "cpu", "gloo")
    pcfg = TPC(mesh=mesh)
    cfg = ranks.serve_cfg(arch)
    enc = cfg.is_encoder_decoder
    specs = tstep.cache_specs_for(
        tmodel.cache_shapes(cfg, ranks.SERVE_B, ranks.SERVE_LEN,
                            cross_len=ranks.SERVE_FRAMES if enc else 0),
        pcfg, cfg)
    jax_cache = ranks.nest({k[len("cache/"):]: v for k, v in
                            _serve_ref(runs[1], arch).items()
                            if k.startswith("cache/")})
    want = dict(flat(cache_from_jax(jax_cache, specs=specs, mesh=mesh)))
    assert set(got["cache"]) == set(want)
    for path, w in want.items():
        w = w.numpy()
        assert got["cache"][path].shape == w.shape, path
        tol = SERVE_TOL * max(np.abs(w).max(), 1)
        assert np.abs(got["cache"][path] - w).max() <= tol, path
    pool = tmodel.cache_shapes(cfg, ranks.SERVE_SLOTS, ranks.SERVE_LEN,
                               cross_len=ranks.SERVE_LEN if enc else 0)
    for path, s in flat(tstep.cache_specs_for(pool, pcfg, cfg)):
        whole = dict(flat(pool))[path].shape
        block = tuple(len(range(*c.indices(n))) for c, n in zip(
            sharded.block_slices(s, whole, mesh), whole))
        assert got["pool"][path] == block, path
    whole_cache = dict(flat(tmodel.cache_shapes(cfg, ranks.SERVE_B,
                                                ranks.SERVE_LEN)))
    # every leaf is [G, B, ...]: the rank's rows; along model the cross
    # caches' kv heads split, so do the xLSTM states' heads or features
    for path, x in got["cache"].items():
        assert x.shape[1] == ranks.SERVE_B // shape[0], path
        if path.endswith(("/xk", "/xv")):
            assert x.shape[3] == cfg.n_kv_heads // shape[1], path
        if "/rec/" in path and cfg.family == "xlstm":
            dim = 2 if path.endswith(("/C", "/n", "/m")) \
                and "layer7" not in path else -1
            want_shape = list(whole_cache[path].shape)
            want_shape[dim] //= shape[1]
            assert list(x.shape) == want_shape, path


def test_sequence_split_decode_adds_nothing_for_an_empty_block(runs):
    """(k) A decode step over a ring cache split over the sequence
    (``attention._decode_seq_split``, the ``(1, 2)`` mesh): the row
    maximum and the exponentials' sum reduced over ``model``, the
    rank's ``p V`` summed, equal to ``decode_attention`` on the whole
    cache for this rank's heads, where rank 0's block holds no key of one
    row and only keys outside the window of another; the new token
    written to the block that owns its slot alone."""
    got = runs[0]["seq_decode"]
    assert got["index"] == 0 and got["block_valid"] == [False, False, True]
    assert np.all(np.isfinite(got["got"]))
    np.testing.assert_allclose(got["got"], got["want"], rtol=1e-6,
                               atol=1e-6)
    assert got["cache"]


def test_copy_to_model_and_reduce_from_model(runs):
    """(k) ``sharded.copy_to_model`` then each ``model`` rank's product
    with its own ``w`` then ``reduce_from_model``, on rank 0 of the
    ``(2, 2)`` mesh, against one process: the output is the sum of the
    ranks' products, ``x``'s gradient the sum of theirs, ``w``'s the
    rank's own; the bytes are the output's (forward) and ``x``'s gradient
    (backward)."""
    got = runs[0]["tp_collectives"]
    x, W, C = got["x"], got["W"], got["C"]
    np.testing.assert_allclose(got["out"], sum(x @ w for w in W),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["gx"], sum(C @ w.T for w in W),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["gw"], x.T @ C, rtol=1e-6, atol=1e-6)
    assert got["wire"] == got["out"].nbytes + got["gx"].nbytes


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen3-moe-30b-a3b",
                                  "seamless-m4t-large-v2", "dbrx-132b"])
def test_serving_mesh_takes_every_config_and_refuses_fsdp(arch):
    """(k) The configs the serving mesh once refused (a stack with other
    than ``A`` / ``L`` / ``R`` layers, MoE FFNs or an encoder) build their
    serve steps and ``ServeEngine`` on a ``(2, 2)`` mesh of CPU tensors
    over the dry run's stand-in group (whose collectives move nothing):
    the engine's serving parameters keep the rank's ``model`` block of
    the experts (4 of 8), of every attention's heads, the encoder's and
    the cross blocks' too, of the mLSTM's and sLSTM's heads, of the
    frontend's ``w1`` columns, and of the head's vocabulary (128 of 256
    columns); ``layout="fsdp"`` still raises ``NotImplementedError``,
    naming the JAX package's own ``DuplicateSpecError`` there."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import model as tmodel
    from repro_torch.parallel import sharded
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    from repro_torch.parallel.sharding import param_specs_for
    from repro_torch.serve import ServeEngine
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths as flat
    cfg = get_config(arch).reduced()
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = dict(flat(tmodel.param_shapes(cfg)))
    with dryrun.standin_group(4):
        mesh = make_mesh_compat((2, 2), ("data", "model"), device="cpu")
        pcfg = TPC(mesh=mesh)
        tstep.make_prefill_step(cfg, pcfg, 96)
        tstep.make_serve_step(cfg, pcfg, 96)
        blocks = sharded.shard_tree(params, param_specs_for(
            tmodel.param_shapes(cfg), pcfg), mesh)
        eng = ServeEngine(cfg, blocks, pcfg, max_len=96)
        served = dict(flat(eng.params))
        cut = {p for p in served if tstep.tp_leaf(p, cfg, pcfg)}
        for path, x in served.items():
            want = list(shapes[path].shape)
            if path in cut:     # the model block: experts, or columns
                dim = 1 if path.endswith(("/wo", "/bq", "/bk", "/bv", "/w",
                                          "/out_norm", "/down")) \
                    or "/moe/" in path or "/b_" in path \
                    or path in ("lm_head/w", "frontend/w1") else 2
                want[dim] //= 2
            assert tuple(x.shape) == tuple(want), path
        kinds = {p.split("/")[-2] for p in cut}
        assert kinds == {"xlstm-1.3b": {"mlstm", "q", "k", "v", "slstm",
                                        "lm_head"},
                         "seamless-m4t-large-v2": {"attn", "xattn", "mlp",
                                                   "lm_head", "frontend"}
                         }.get(arch, {"attn", "moe", "lm_head"}), kinds
        if cfg.is_encoder_decoder:
            assert any(p.startswith("encoder/") for p in cut)
        with pytest.raises(NotImplementedError, match="DuplicateSpecError"):
            tstep.make_prefill_step(cfg, TPC(mesh=mesh, layout="fsdp"), 96)
        with pytest.raises(NotImplementedError, match="DuplicateSpecError"):
            ServeEngine(cfg, blocks, TPC(mesh=mesh, layout="fsdp"),
                        max_len=96)


def test_vocab_parallel_embedding_raises_on_a_mesh(monkeypatch):
    """``embed_mode="vocab_parallel"`` (the JAX package's masked take of
    each ``model`` rank's vocab block) runs on a mesh of several
    ``model`` ranks and no longer raises: each rank of a ``(2, 2)`` mesh
    takes the tokens of its rows of the table (the table's block, or a
    view of a whole one), and the ranks' results added in rank order
    (``sharded.reduce_from_model``'s sum over ``model``, the identity
    here, added by hand) equal the gather embedding bit for bit; without
    a mesh, or with one ``model`` rank, the knob does not act (in either
    package) and the lookup is the table's rows.  The sum over real
    ranks: ``tests/test_torch_vocab.py``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.models import transformer
    from repro_torch.parallel import sharded
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    cfg = get_config("qwen2.5-3b").reduced().replace(
        param_dtype="float32", compute_dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = params["embed"]["w"]
    toks = torch.tensor([[1, 5, 7, 127, 128, 255]], dtype=torch.int32)
    monkeypatch.setattr(sharded, "reduce_from_model", lambda x, mesh: x)
    for whole in (True, False):
        total = None
        for rank in range(2):       # data 0, model 0 and 1
            grid = Mesh(("data", "model"), {"data": 2, "model": 2}, object(),
                        rank, 4, "cpu", "gloo")
            i = grid.axis_index("model")
            table = w if whole else w[i * 128:(i + 1) * 128].clone()
            x = transformer.embed(
                {"embed": {"w": table}}, toks, cfg=cfg,
                pcfg=TPC(mesh=grid, embed_mode="vocab_parallel"))
            total = x if total is None else total + x
        assert torch.equal(total, w[toks.long()])
    rows = Mesh(("data", "model"), {"data": 4, "model": 1}, object(), 0, 4,
                "cpu", "gloo")
    for pcfg in (TPC(embed_mode="vocab_parallel"),
                 TPC(mesh=rows, embed_mode="vocab_parallel")):
        x = transformer.embed(params, toks, cfg=cfg, pcfg=pcfg)
        assert torch.equal(x, params["embed"]["w"][toks.long()])


def _lru_gather_bytes(cfg, rows: int, tokens: int, backward: bool) -> int:
    """The bytes a rank of the ``(1, 3)`` mesh hands to the RG-LRU's
    gathers of its conv output (float32): each R layer's ``[rows,
    tokens, W / 3]`` slice forward, and the whole ``[rows, tokens, W]``
    gradient to the reduce-scatter backward."""
    layers = cfg.block_pattern.count("R") * cfg.n_groups
    part = rows * tokens * cfg.lru_width // 3 * 4
    return layers * part * (1 + 3 * backward)


def test_tp_step_splits_an_lru_whose_gate_blocks_do_not_split(runs):
    """(l) ``torch_train_ranks.LRU_SPLIT`` on ``(data, model) = (1, 3)``,
    ``layout="tp"``: 3 ranks divide the LRU width of 48 but not the
    gates' 8 blocks of 6, so each rank's slice of 16 columns crosses
    blocks: ``rglru.lru_split`` is ``(0, 3)`` on rank 0, the layer
    computes on the rank's slice from its conv output gathered over
    ``model`` (those bytes exactly: ``all_gather`` carries nothing else
    here) while the attention computes on one of the 3 heads a rank.
    One step, rank 0, against the JAX package's step by ``_hold``'s
    bars; the layers' sums over ``model`` ran."""
    port, ref = runs
    got = port["lru_split"]
    assert got["split"] == (0, 3)
    _hold(got["step"], _ref(ref, ranks.LRU_SPLIT, "tp"),
          [_ref(ref, ranks.LRU_SPLIT, "tp", t) for t in "uvwx"])
    assert got["wire"]["tp_all_reduce"] > 0
    assert got["wire"]["all_gather"] == _lru_gather_bytes(
        ranks.lm_cfg(ranks.LRU_SPLIT), ranks.B, ranks.T, backward=True)


def test_serving_mesh_splits_an_lru_whose_gate_blocks_do_not_split(runs):
    """(l) The serve steps and the engine of ``LRU_SPLIT`` (one pattern
    unit) on the ``(1, 3)`` mesh, rank 0, against the JAX package's on
    its host mesh, by ``test_serving_mesh_matches_jax_host_mesh``'s
    bars: ``check_serving_mesh`` takes the config, the serve steps gather
    the conv output of each R layer (the prefill's and two decode steps'
    bytes exactly, by ``sharded.all_gather``), and the RG-LRU state of
    the prefill's cache and of the pool is the rank's slice of the LRU
    width of 48 (``cache_specs_for(..., cfg)``), equal to the JAX
    package's cache cut there."""
    from repro_torch.convert import cache_from_jax
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths as flat
    port, ref = runs
    got = port["lru_split"]["serve"]
    want = _serve_ref(ref, ranks.LRU_SPLIT)
    for key in ("prefill", "decode"):
        scale = np.abs(want[key]).max()
        assert got[key].shape == want[key].shape, key
        assert np.abs(got[key] - want[key]).max() <= SERVE_TOL * scale, key
    np.testing.assert_array_equal(got["next"], want["next"])
    assert got["tokens"] == want["tokens"].tolist()
    cfg = ranks.serve_cfg(ranks.LRU_SPLIT)
    assert got["autograd_gather"] == _lru_gather_bytes(
        cfg, ranks.SERVE_B, ranks.SERVE_T, backward=False) \
        + 2 * _lru_gather_bytes(cfg, ranks.SERVE_B, 1, backward=False)
    assert got["wire"]["all_gather"] >= got["autograd_gather"]
    mesh = Mesh(("data", "model"), dict(zip(("data", "model"),
                                            ranks.LRU_SPLIT_SHAPE)),
                object(), 0, 3, "cpu", "gloo")
    specs = tstep.cache_specs_for(
        tmodel.cache_shapes(cfg, ranks.SERVE_B, ranks.SERVE_LEN),
        TPC(mesh=mesh), cfg)
    jax_cache = ranks.nest({k[len("cache/"):]: v for k, v in want.items()
                            if k.startswith("cache/")})
    cut = dict(flat(cache_from_jax(jax_cache, specs=specs, mesh=mesh)))
    pool = dict(flat(tmodel.cache_shapes(cfg, ranks.SERVE_SLOTS,
                                         ranks.SERVE_LEN)))
    rec = [p for p in pool if "/rec/" in p]
    assert rec
    for path in rec:
        w = cut[path].numpy()
        assert got["cache"][path].shape == w.shape, path
        assert w.shape[-1] == cfg.lru_width // 3, path
        assert np.abs(got["cache"][path] - w).max() <= SERVE_TOL * max(
            np.abs(w).max(), 1), path
        assert got["pool"][path] == tuple(pool[path].shape[:-1]) + (
            cfg.lru_width // 3,), path


def test_serve_launcher_rank_on_a_two_by_two_mesh(runs):
    """(k) The serving launcher's rank body (``--ranks 4``: the ``(2, 2)``
    mesh) serves every request, each with its new tokens."""
    got = runs[0]["launcher"]
    assert len(got["reqs"]) == 4
    assert all(len(o) == 4 for _, _, o in got["reqs"])


# ------------------------------------------------------------ (f), (g), (h)
@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    """A single-device run's checkpoint at step 2, then the 2-rank
    checkpoint suite and the 2-rank elastic suite."""
    tmp = tmp_path_factory.mktemp("ckpt")
    from repro_torch.configs import get_config
    cfg = get_config(ranks.CKPT_ARCH).reduced()
    tr, client = ranks._trainer(cfg, None, tmp / "single", tag="single")
    tr.run(2)
    single = {"tree": ranks.whole_tree(tr),
              "files": ranks.ckpt_files(client, "single", 2),
              "cursor": tr.pipeline.state_dict()}
    mesh = run_ranks(ranks.ckpt_suite, 2, (str(tmp / "mesh"),
                                           single["files"]),
                     timeout_s=120, join_timeout_s=300)[0]
    elastic = run_ranks(ranks.elastic_suite, 2, (str(tmp / "el"),),
                        timeout_s=120, join_timeout_s=300)
    return cfg, single, mesh, elastic, tmp


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_checkpoint_written_on_two_ranks_restores_on_one_and_in_jax(
        ckpt_runs):
    cfg, single, mesh, _, tmp = ckpt_runs
    tr, client = ranks._trainer(cfg, None, tmp / "restore1", tag="ck")
    ranks.upload(client, mesh["files"])
    tr._build()
    assert tr.step_idx == 2 and tr.pipeline.state_dict() == mesh["cursor"]
    _same(ranks.whole_tree(tr), mesh["written"])
    # the JAX package's checkpointer reads the same files
    from conftest import make_cloud
    from repro.configs import ARCHS
    from repro.models import model as jmodel
    from repro.train import optim as joptim
    from repro.utils.pytree import tree_flatten_with_paths as jflat
    _, _, jclient = make_cloud(tmp / "jax")
    ranks.upload(jclient, mesh["files"])
    jcfg = ARCHS[ranks.CKPT_ARCH].reduced()
    shapes = jmodel.param_shapes(jcfg)
    got = JCheckpointer(jclient, "ck").restore_latest(
        {"params": shapes, "opt": joptim.state_shapes(
            shapes, joptim.AdamWConfig())})
    assert got["step"] == 2
    flat = {p: np.asarray(x, np.float32) for p, x in
            jflat({"opt": got["opt"], "params": got["params"]})}
    _same(flat, mesh["written"])


def test_checkpoint_written_on_one_device_restores_on_two_ranks(ckpt_runs):
    _, single, mesh, _, _ = ckpt_runs
    assert mesh["restored_step"] == 2
    assert mesh["restored_cursor"] == single["cursor"]
    _same(mesh["restored"], single["tree"])


def test_elastic_restart_resumes_from_checkpoint(ckpt_runs):
    *_, elastic, _ = ckpt_runs
    r0, r1 = elastic[0]["restart"], elastic[1]["restart"]
    assert r0["restarts"] == 1 and r0["final_step"] >= 12
    assert r1["left_out"] and r1["final_step"] is None
    losses = [loss for _, loss in r0["history"]]
    assert losses[-1] < losses[0]
    # the history from the restored step (4) is the uninterrupted run's
    after = r0["history"][3:]
    whole = dict(elastic[0]["whole"])
    assert [s for s, _ in after] == [6, 8, 10, 12]
    for s, loss in after:
        np.testing.assert_allclose(loss, whole[s], rtol=1e-5, err_msg=s)


def test_elastic_multiple_failures(ckpt_runs):
    *_, elastic, _ = ckpt_runs
    r0 = elastic[0]["twice"]
    assert r0["restarts"] == 2 and r0["final_step"] >= 12
    whole = dict(elastic[0]["whole"])
    for s, loss in r0["history"][-2:]:
        np.testing.assert_allclose(loss, whole[s], rtol=1e-5, err_msg=s)


def test_elastic_gives_up_after_max_restarts(ckpt_runs):
    *_, elastic, _ = ckpt_runs
    for rank in (0, 1):
        assert "raised" in elastic[rank]["give_up"]


def test_launcher_podwise_int8_on_cpu_ranks(capsys):
    assert tlaunch.main(["--arch", "recurrentgemma-2b", "--smoke",
                         "--device", "cpu", "--ranks", "2", "--multi-pod",
                         "--mode", "podwise", "--compress", "int8_ef",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--tokens", "20000"]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "mode podwise" in out


@pytest.mark.parametrize("arch",
                         sorted(ranks.PJIT_CASES) + list(ranks.MOE_ARCHS))
def test_spec_trees_match_jax(arch):
    """The port's spec trees (``param_specs_for`` by the copied
    ``_RULES``, the state's with ``ef`` under ``multi_pod``, the batch's,
    a decode cache's) equal the JAX package's for every shipped config,
    on a ``(pod, data, model) = (2, 2, 2)`` grid (JAX reads only its axis
    names and sizes here), the xLSTM's states by heads or features too."""
    from types import SimpleNamespace

    from repro.configs import ARCHS
    from repro.models import model as jmodel
    from repro.parallel.sharding import ParallelConfig as JPC
    from repro.train import optim as joptim
    from repro.train import step as jstep
    from repro.utils.pytree import tree_flatten_with_paths as jflat
    from repro_torch.configs import get_config
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.mesh_utils import Mesh
    from repro_torch.parallel.sharding import ParallelConfig as TPC
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths as tflat

    axes, shape = ("pod", "data", "model"), (2, 2, 2)
    jmesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    tmesh = Mesh(axes, dict(zip(axes, shape)), object(), 0, 8, "cpu", "gloo")
    jcfg, tcfg = ARCHS[arch], get_config(arch)

    def same(j, t):
        jl, tl = jflat(j), tflat(t)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (p, a), (_, b) in zip(jl, tl):
            assert tuple(a) == tuple(b), (p, a, b)

    for layout in ("tp", "fsdp"):
        jp = JPC(mesh=jmesh, multi_pod=True, layout=layout)
        tp = TPC(mesh=tmesh, multi_pod=True, layout=layout)
        jo = joptim.AdamWConfig(error_feedback=True)
        to = toptim.AdamWConfig(error_feedback=True)
        same(jstep.opt_state_specs_for(jmodel.param_shapes(jcfg), jp, jo),
             tstep.opt_state_specs_for(tmodel.param_shapes(tcfg), tp, to))
        batch = {"inputs": np.zeros((8, 16)), "labels": np.zeros((8, 16))}
        same(jstep.batch_specs_for(batch, jp),
             tstep.batch_specs_for(batch, tp))
        jl = jflat(jstep.cache_specs_for(jmodel.cache_shapes(jcfg, 8, 64),
                                         jp))
        tl = tflat(tstep.cache_specs_for(tmodel.cache_shapes(tcfg, 8, 64),
                                         tp, tcfg))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (p, a), (_, b) in zip(jl, tl):
            assert tuple(a) == tuple(b), (p, a, b)


@pytest.mark.parametrize("variant", [ranks.HEADS_WHOLE, ranks.RING_WHOLE])
def test_serving_mesh_serves_heads_and_caches_that_do_not_split(runs,
                                                               variant):
    """(m) The serving mesh takes every A / L / R mesh the JAX serve steps
    lower on (once refused with a ``ValueError``): one R, L and A layer
    on ``(data, model) = (1, 3)``, rank 0, against the JAX package's
    serve steps on three host devices at ``(1, 3)``, by
    ``test_serving_mesh_matches_jax_host_mesh``'s bars.  ``HEADS_WHOLE``:
    4 heads over 2 kv heads do not split over 3, so the attention serves
    whole on every ``model`` rank with whole caches (the ring of 40 slots
    and the full cache of 96), its output summed over nothing;
    ``RING_WHOLE``: 3 heads over 1 kv head split, the ring of 40 slots
    does not and stays whole beside them (``attention._whole_cache``),
    the full cache of 96 splits over the sequence.  The R layer computes
    on its slice of the LRU width of 48 in both, its output summed over
    ``model``: ``HEADS_WHOLE``'s only sums."""
    from repro_torch.models import model as tmodel
    from repro_torch.utils.pytree import tree_flatten_with_paths as flat
    port, ref = runs
    got = port["serve_whole"][variant]
    want = _serve_ref(ref, variant, "serve13")
    for key in ("prefill", "decode"):
        scale = np.abs(want[key]).max()
        assert got[key].shape == want[key].shape, key
        assert np.abs(got[key] - want[key]).max() <= SERVE_TOL * scale, key
    np.testing.assert_array_equal(got["next"], want["next"])
    assert got["tokens"] == want["tokens"].tolist()
    # the pool's K / V / kpos: whole over model, but RING_WHOLE's full
    # cache (layer 2, the A layer) split over the sequence
    cfg = ranks.serve_cfg(variant)
    pool = {p: tuple(s.shape) for p, s in flat(tmodel.cache_shapes(
        cfg, ranks.SERVE_SLOTS, ranks.SERVE_LEN))}
    attn = [p for p in got["pool"] if p.endswith(("/k", "/v", "/kpos"))]
    assert len(attn) == 5
    for path in attn:
        shape = pool[path]
        if variant == ranks.RING_WHOLE and path.startswith("layer2/"):
            shape = shape[:2] + (shape[2] // 3,) + shape[3:]
        assert got["pool"][path] == shape, path
    if variant == ranks.HEADS_WHOLE:     # the R layer's outputs alone
        rows = ranks.SERVE_B * (ranks.SERVE_T + 2)   # prefill, 2 decodes
        assert got["wire"]["tp_all_reduce"] == cfg.n_groups \
            * cfg.block_pattern.count("R") * rows * cfg.d_model * 4
    else:
        assert got["wire"]["tp_all_reduce"] > 0
    assert got["wire"]["gather"] == 0
