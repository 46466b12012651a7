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
    _, tcfg = _cfgs()
    _, tp, _, tx = _setup()
    with pytest.raises(ValueError):
        tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="ring"))
    from repro_torch.parallel.mesh_utils import Mesh
    grid = Mesh(("data", "model"), {"data": 1, "model": 2}, object(), 0, 2,
                "cpu", "gloo")
    with pytest.raises(NotImplementedError, match="1.3g"):
        tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(mesh=grid, layout="fsdp",
                                              moe_dispatch="a2a"))
    # under tp the JAX package falls back to gather, and so does the port
    oa, _ = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(mesh=grid,
                                                  moe_dispatch="a2a"))
    og, _ = tmoe.apply(tp, tx, cfg=tcfg, pcfg=TPC(moe_dispatch="gather"))
    assert torch.equal(oa, og)


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
