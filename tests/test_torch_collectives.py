"""The port's cross-pod gradient reduction and the global norm on
blocks, over gloo ranks on the CPU.

(c) ``cross_pod_mean`` over 4 pods (one rank each,
    ``torch_train_ranks.collectives_suite``) against the JAX package's in
    a full-manual ``shard_map`` over 4 host devices (the recipe of
    ``test_spmd_subprocess.py::test_compressed_cross_pod_close_to_exact``),
    on the same ``[4, 256]`` float32 gradient, a row a pod: ``int8_ef``'s
    mean and residual bit for bit, over two rounds (the second carrying
    the first's residual); ``none`` within one float32 rounding of the
    exact mean (gloo and XLA sum four terms in their own orders) and
    ``bf16`` within bf16 rounding of it; the bytes each mode hands to the
    wire 4 : 2 : 1 (float32, bf16, int8), plus int8's scale.
(d) ``global_norm`` of blocks on a ``(data, model) = (2, 2)`` mesh equals
    the whole tree's norm, with a replicated leaf (``P()``), a leaf whose
    spec ``validate_spec`` dropped, and one of a single element.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_train_ranks as ranks
from repro_torch.launch.mesh import run_ranks

ROOT = os.path.join(os.path.dirname(__file__), "..")

_JAX = """
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_mesh_compat
from repro.parallel import collectives
import torch_train_ranks as R
mesh = make_mesh_compat((4,), ("pod",))
g = jnp.asarray(R.pod_grads())
out = {}
for mode in ("none", "bf16", "int8_ef"):
    def body(gl, efl):
        red, ef2 = collectives.cross_pod_mean(
            {"w": gl[0]}, compress=mode,
            ef_state={"w": efl[0]} if mode == "int8_ef" else None)
        e = ef2["w"] if ef2 is not None else efl[0]
        return red["w"][None], e[None]
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                           out_specs=(P("pod"), P("pod"))))
    red, ef = fn(g, jnp.zeros_like(g))
    out[mode] = np.asarray(red)
    out[mode + "_ef"] = np.asarray(ef)
    if mode == "int8_ef":
        red2, ef2 = fn(g, ef)
        out["int8_ef_2"] = np.asarray(red2)
        out["int8_ef_2_ef"] = np.asarray(ef2)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dest = str(tmp_path_factory.mktemp("coll") / "jax.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.dirname(__file__)])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), dest], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = run_ranks(ranks.collectives_suite, 4, timeout_s=120,
                         join_timeout_s=300)
    finally:
        _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return port, dict(np.load(dest))


def test_int8_ef_matches_jax_bit_for_bit(runs):
    port, ref = runs
    for rank, out in enumerate(port):
        mean, ef, _ = out["int8_ef"]
        assert np.array_equal(mean, ref["int8_ef"][rank])
        assert np.array_equal(ef, ref["int8_ef_ef"][rank])
        assert np.abs(ef).max() > 0                  # the residual carried
        mean2, ef2 = out["int8_ef_2"]
        assert np.array_equal(mean2, ref["int8_ef_2"][rank])
        assert np.array_equal(ef2, ref["int8_ef_2_ef"][rank])
    g = ranks.pod_grads()
    exact = g.mean(0)
    assert np.abs(port[0]["int8_ef"][0] - exact).max() < np.abs(g).max() / 64


@pytest.mark.parametrize("mode", ["none", "bf16"])
def test_uncompressed_and_bf16_means(runs, mode):
    port, ref = runs
    g = ranks.pod_grads().astype(np.float64)
    exact = g.mean(0)
    # none: four float32 terms summed in some order, then halved twice;
    # bf16: each term and the sum rounded to 8 bits
    tol = (np.abs(g).sum(0) / 4 * (4 * 2.0 ** -24 if mode == "none"
                                   else 3 * 2.0 ** -8)) + 1e-30
    for rank, out in enumerate(port):
        mean, ef, _ = out[mode]
        assert ef is None
        assert np.all(np.abs(mean - exact) <= tol)
        assert np.all(np.abs(ref[mode][rank] - exact) <= tol)


def test_wire_bytes_in_ratio(runs):
    port, _ = runs
    n = int(np.prod(ranks.POD_SHAPE)) // 4
    for out in port:
        f32, bf16, int8 = (out[m][2] for m in ("none", "bf16", "int8_ef"))
        assert (f32, bf16, int8) == (4 * n, 2 * n, n + 4)
    assert port[0]["ratio"] == 0.5


def test_global_norm_of_blocks_is_the_whole_trees(runs):
    port, _ = runs
    rng = np.random.default_rng(3)
    whole = [rng.normal(size=(8, 6)), rng.normal(size=(5, 4)),
             rng.normal(size=(6,)), rng.normal(size=(1,))]
    want = np.sqrt(sum(np.square(x.astype(np.float32).astype(np.float64))
                       .sum() for x in whole))
    out = port[0]
    assert out["norm_specs"]["odd"] == (None, "model")   # 5 rows: dropped
    assert out["norm_specs"]["one"] == (None,)
    assert out["block_shapes"] == {"w": (4, 3), "odd": (5, 2),
                                   "scale": (6,), "one": (1,)}
    for o in port:
        np.testing.assert_allclose(o["norm"], want, rtol=1e-6)
        assert o["roundtrip"]
