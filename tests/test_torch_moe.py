"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU.

Parameters are made by ``repro.models.common.materialize`` at a seed and
carried across (``convert.params_from_jax``); inputs are made from one
numpy seed and fed to both packages.  The config is the reduced
``qwen3-moe-30b-a3b`` (8 experts, top-2, expert width 32) in float32.

Routing must be equal, not close: the expert ids, the positions in the
expert and the kept set exactly, the gates within 1e-6 (a float32
softmax).  Outputs within rtol 1e-4 / atol 1e-5 (the JAX package's own
``tests/test_moe.py`` tolerance; sums in another order), gradients
within 1e-5 of each leaf's largest magnitude.

On a mesh (``test_mesh_apply_matches_jax``), 4 gloo ranks each run the
layer on their rows (``torch_train_ranks.moe_mesh_suite``, no JAX) while
the JAX package runs the global batch in a subprocess with 4 host
devices: its ``_apply_a2a`` on the same host mesh for the expert
all-to-all, its meshless ``apply`` for the global grouping.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import moe as jmoe
from repro.models.common import materialize
from repro.parallel.sharding import ParallelConfig as JPC
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.parallel.sharding import ParallelConfig as TPC

NAME = "qwen3-moe-30b-a3b"
TOL = dict(rtol=1e-4, atol=1e-5)
MODES = ("einsum", "gather")


def _cfgs():
    return (ARCHS[NAME].reduced().replace(param_dtype="float32",
                                          compute_dtype="float32"),
            tconfigs.get_config(NAME).reduced().replace(
                param_dtype="float32", compute_dtype="float32"))


def _setup(B=2, T=16, seed=1, uniform=False):
    """(JAX params, port params, JAX x, port x); ``uniform``: a zero
    router, so every expert ties."""
    jcfg, _ = _cfgs()
    jp = materialize(jmoe.shapes(jcfg), jax.random.PRNGKey(0))
    if uniform:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = np.random.default_rng(seed).standard_normal(
        (B, T, jcfg.d_model)).astype(np.float32)
    return (jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
            jnp.asarray(x), torch.from_numpy(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("case", ["random", "uniform_router", "one_group",
                                  "many_groups"])
def test_route_matches_jax_exactly(case):
    """``_route``: eids, positions and the kept set equal to the JAX
    package's, gates within 1e-6, aux within 1e-6 of it.  A uniform
    router ties every expert (``lax.top_k`` takes the lower index
    first); ``many_groups`` routes 4 groups of 8."""
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _setup(uniform=case == "uniform_router",
                            T=1 if case == "one_group" else 16)
    G = 4 if case == "many_groups" else 1
    jxg, txg = jx.reshape(G, -1, jcfg.d_model), tx.reshape(G, -1,
                                                          jcfg.d_model)
    jg, je, jpos, jaux = jmoe._route(jp, jxg, jcfg)
    tg, te, tpos, taux = tmoe._route(tp, txg, tcfg)
    np.testing.assert_array_equal(_np(te), _np(je))
    np.testing.assert_array_equal(_np(tpos), _np(jpos))
    C = jmoe.capacity(jxg.shape[1], jcfg)
    assert C == tmoe.capacity(txg.shape[1], tcfg)
    np.testing.assert_array_equal(_np(tpos) < C, _np(jpos) < C)
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=0, atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    if case == "uniform_router":
        assert (_np(te) == np.arange(jcfg.top_k)).all()


def test_positions_by_sort_matches_jax():
    """First-come ranks within each expert's run, over crowded ids."""
    flat = np.random.default_rng(3).integers(0, 5, (3, 40)).astype(np.int32)
    want = np.asarray(jmoe._positions_by_sort(jnp.asarray(flat)))
    got = tmoe._positions_by_sort(torch.from_numpy(flat).long()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_apply_matches_jax(mode, factor, monkeypatch):
    """``apply`` at the default capacity (tokens dropped) and at a
    no-drop factor of 8, in both dispatch modes, against the JAX
    package's; the aux loss too."""
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", factor)
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", factor)
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _setup()
    jout, jaux = jmoe.apply(jp, jx, cfg=jcfg, pcfg=JPC(moe_dispatch=mode))
    tout, taux = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch=mode))
    np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_grouping_rule_matches_jax(monkeypatch):
    """GROUP_SIZE 16 over 2 x 12 tokens halves to groups of 8 (``while
    total % group: group //= 2``): three groups, each with its own
    capacity."""
    monkeypatch.setattr(jmoe, "GROUP_SIZE", 16)
    monkeypatch.setattr(tmoe, "GROUP_SIZE", 16)
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _setup(T=12)
    for mode in MODES:
        jout, jaux = jmoe.apply(jp, jx, cfg=jcfg,
                                pcfg=JPC(moe_dispatch=mode))
        tout, taux = tmoe.apply(tp, tx, cfg=tcfg,
                                pcfg=TPC(moe_dispatch=mode))
        np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
        assert abs(float(taux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("factor", [8.0, 1.25, 0.25])
def test_einsum_matches_gather(factor, monkeypatch):
    """The two modes agree with no drops (factor 8) and drop the same
    tokens under the default and a tight capacity: a token whose every
    slot is dropped comes out zero in both."""
    monkeypatch.setattr(tmoe, "CAPACITY_FACTOR", factor)
    _, tcfg = _cfgs()
    _, tp, _, tx = _setup(uniform=factor == 0.25)
    oe, ae = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="einsum"))
    og, ag = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="gather"))
    np.testing.assert_allclose(_np(oe), _np(og), **TOL)
    assert float(ae) == float(ag)
    if factor == 0.25:          # uniform router: capacity 8 of 32 slots
        zero = (og.abs().amax(-1) == 0).numpy()
        assert zero.any() and ((oe.abs().amax(-1) == 0).numpy() == zero).all()


def test_a2a_without_a_mesh_is_gather():
    _, tcfg = _cfgs()
    _, tp, _, tx = _setup()
    oa, aa = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="a2a"))
    og, ag = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="gather"))
    assert torch.equal(oa, og) and torch.equal(aa, ag)


def test_dispatch_modes_and_the_mesh():
    """An unknown mode raises.  On a ``(data, model) = (1, 2)`` mesh the
    batch ranks are ``model``'s two under fsdp (where ``a2a`` runs the
    expert all-to-all, held to the JAX package by
    ``test_mesh_apply_matches_jax``) and none under tp, where ``a2a``
    falls back to ``gather`` as in the JAX package: split over the two
    ``model`` ranks there (``ep_split``, held to the JAX package by the
    same test), and on ``(1, 3)``, whose 3 ranks do not divide the 8
    experts, the meshless ``gather`` whole."""
    _, tcfg = _cfgs()
    _, tp, _, tx = _setup()
    with pytest.raises(ValueError):
        tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="ring"))
    from repro_torch.parallel.mesh_utils import Mesh
    grid = Mesh(("data", "model"), {"data": 1, "model": 2}, object(), 1, 2,
                "cpu", "gloo")
    ranks = tmoe._batch_ranks(TPC(mesh=grid, layout="fsdp",
                                  moe_dispatch="a2a"))
    assert (ranks.axes, ranks.size, ranks.index) == (("model",), 2, 1)
    assert (ranks.model_size, ranks.model_index) == (2, 1)
    assert tmoe._batch_ranks(TPC(mesh=grid)) is None
    assert tmoe.ep_split(tcfg, TPC(mesh=grid)) == (1, 2)
    assert tmoe.ep_split(tcfg, TPC(mesh=grid, layout="fsdp")) is None
    # under tp the JAX package falls back to gather, and so does the port
    trio = Mesh(("data", "model"), {"data": 1, "model": 3}, object(), 1, 3,
                "cpu", "gloo")
    assert tmoe.ep_split(tcfg, TPC(mesh=trio)) is None
    oa, _ = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(mesh=trio,
                                                  moe_dispatch="a2a"))
    og, _ = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="gather"))
    assert torch.equal(oa, og)


# ------------------------------------------------------------ on a mesh
_JAX_MESH = """
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS
from repro.models import moe
from repro.parallel.sharding import ParallelConfig
import torch_train_ranks as R

cfg = ARCHS[R.MOE_ARCH].reduced().replace(param_dtype="float32",
                                          compute_dtype="float32")
res = {}
for name, (shape, layout, dispatch, factor, bt, group) in \\
        R.MOE_MESH_CASES.items():
    p_np, x_np, ct_np = R.moe_inputs(cfg, bt)
    moe.CAPACITY_FACTOR, moe.GROUP_SIZE = factor, group
    if dispatch == "a2a":     # the expert all-to-all on the host mesh
        kw = {}
        if hasattr(jax.sharding, "AxisType"):
            kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = jax.sharding.Mesh(devs, ("data", "model"), **kw)
        pcfg = ParallelConfig(mesh=mesh, layout=layout, moe_dispatch="a2a")
    else:                     # the global batch on one device
        mesh, pcfg = None, ParallelConfig(moe_dispatch=dispatch)
    ct = jnp.asarray(ct_np)

    def loss(p, x):
        out, aux = moe.apply(p, x, cfg=cfg, pcfg=pcfg)
        return jnp.sum(out * ct) + aux, (out, aux)
    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    args = ({k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x_np))
    if mesh is None:
        (_, (out, aux)), (gp, gx) = fn(*args)
    else:
        with (jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh):
            (_, (out, aux)), (gp, gx) = fn(*args)
    res[name + "|out"], res[name + "|aux"] = np.asarray(out), np.asarray(aux)
    res[name + "|gx"] = np.asarray(gx)
    res.update({f"{name}|g/{k}": np.asarray(v) for k, v in gp.items()})
np.savez(sys.argv[1], **res)
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(every rank's ``moe_mesh_suite`` results, the JAX references):
    4 gloo ranks, and meanwhile the JAX package on 4 host devices in a
    subprocess (``--xla_force_host_platform_device_count``)."""
    import os
    import subprocess
    import sys
    import textwrap

    import torch_train_ranks as ranks
    from repro_torch.launch.mesh import run_ranks
    here = os.path.dirname(__file__)
    dest = tmp_path_factory.mktemp("moe_mesh") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(here, "..", "src"),
                                           here]))
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_MESH), str(dest)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = run_ranks(ranks.moe_mesh_suite, 4, timeout_s=120,
                         join_timeout_s=300)
    finally:
        _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return port, dict(np.load(dest))


def _mesh_cases():
    import torch_train_ranks as ranks
    return list(ranks.MOE_MESH_CASES)


@pytest.mark.parametrize("case", _mesh_cases())
def test_mesh_apply_matches_jax(mesh_runs, case):
    """``moe.apply`` on each rank's rows of a host mesh of gloo ranks
    against the JAX package on the global batch: ``a2a`` against its
    ``_apply_a2a`` on the same host mesh under fsdp, ``einsum`` and
    ``gather`` (and ``a2a``'s tp fallback) against the meshless
    ``apply``.  The rows of the output and of the gradient by ``x`` at
    ``TOL`` / 1e-5 of the largest magnitude, the aux loss (the same on
    every rank) within 1e-6, and each parameter's gradient summed over
    the batch ranks within 1e-5 of its largest magnitude.  At a factor
    of 0.5 slots are dropped (the rows whose every slot is dropped come
    out zero); in the straddle case a rank's tokens lie in two groups.
    Under ``tp`` where ``model`` divides the 8 experts (``moe.ep_split``:
    ``(2, 2)`` and ``(1, 2)``) each rank holds its 4 experts alone (their
    gradients gathered over ``model`` here), the router's gradient, whose
    aux term only ``model`` rank 0 carries, counts the aux once, and every
    ``model`` rank of one batch rank dispatches with the same ``C_l``; on
    ``(1, 3)`` the layer computes whole on every rank."""
    import torch_train_ranks as ranks
    port, ref = mesh_runs
    got = [r[case] for r in port if case in r]
    shape, *_, (B, T), _ = ranks.MOE_MESH_CASES[case]
    assert len(got) == shape[0] * shape[1]
    rows = {g["index"]: g for g in got}
    assert sorted(rows) == list(range(len(rows)))
    out = np.concatenate([rows[i]["out"] for i in sorted(rows)])
    gx = np.concatenate([rows[i]["gx"] for i in sorted(rows)])
    np.testing.assert_allclose(out, ref[case + "|out"], **TOL)
    want = ref[case + "|gx"]
    assert np.abs(gx - want).max() <= 1e-5 * np.abs(want).max()
    for g in got:
        assert abs(g["aux"] - float(ref[case + "|aux"])) <= 1e-6
        for name, v in g["grads"].items():
            want = ref[f"{case}|g/{name}"]
            assert np.isfinite(v).all(), name
            assert np.abs(v - want).max() <= 1e-5 * np.abs(want).max(), name
    if case.endswith("drops"):
        assert (np.abs(out).max(-1) == 0).any()
    layout = ranks.MOE_MESH_CASES[case][1]
    split = layout == "tp" and 8 % shape[1] == 0
    for g in got:
        assert (g["block"] is not None) == split
        assert g["experts"][0] == (8 // shape[1] if split else 8)
        if split:
            assert tuple(g["block"]) == (g["model_index"], shape[1])
        if layout == "tp":
            peers = [h["caps"] for h in got if h["index"] == g["index"]]
            assert g["caps"] and all(c == g["caps"] for c in peers)


def test_aux_loss_uniform_router():
    """A uniform router gives aux = coef: every token's top-1 is expert
    0 and every mean probability 1/E (the JAX test's bound, 30%, holds
    with room)."""
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _setup(uniform=True)
    _, taux = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC())
    _, jaux = jmoe.apply(jp, jx, cfg=jcfg, pcfg=JPC())
    assert abs(float(taux) / tcfg.router_aux_coef - 1.0) < 1e-6
    assert abs(float(taux) - float(jaux)) <= 1e-9


@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_jax(mode):
    """d(sum(out**2) + aux) by every parameter and by x, at the default
    capacity, against ``jax.grad`` of the same loss; all finite and the
    router's and the experts' nonzero (the JAX test's checks)."""
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _setup()

    def jloss(p, x):
        out, aux = jmoe.apply(p, x, cfg=jcfg, pcfg=JPC(moe_dispatch=mode))
        return jnp.sum(out ** 2) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = tx.requires_grad_()
    out, aux = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch=mode))
    (out.pow(2).sum() + aux).backward()
    for name, want in [*jgp.items(), ("x", jgx)]:
        got = (tx if name == "x" else tp[name]).grad.numpy()
        want = np.asarray(want)
        assert np.isfinite(got).all(), name
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale, name
    assert float(tp["wi"].grad.abs().sum()) > 0
    assert float(tp["router"].grad.abs().sum()) > 0
