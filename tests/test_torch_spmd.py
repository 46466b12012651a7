"""The port's ``core.spmd`` over gloo ranks on the CPU, against the JAX
package.

Each mesh size ``D`` in {1, 2, 4} is one spawn of ``D`` ranks
(``launch.mesh.run_ranks``: a ``file://`` store, a 60 s collective
timeout, a joined-or-killed deadline) that runs every entry of
``core.spmd`` on its blocks (``torch_mesh_ranks.spmd_suite``); the tests
below read that one run.  Inputs come from numpy seeds.

* ``fused_scatter_round`` on ragged rounds (hash and range partitioners,
  empty slots, a rank whose whole block is empty, 4 and 8 workers): every
  worker's ``parts[:counts]`` byte-identical to the host harvest of the
  JAX package's single-device round (``scatter_round_dispatch`` on the
  CPU) and to the port's own single-device round; ``counts`` and
  ``hist_sb`` exactly equal, on every rank.  (The JAX package's mesh
  round is not the reference: it raises on the installed jax.)
* ``distributed_sort`` and ``barrier_sort``: every rank's block
  bit-identical to block ``r`` of the JAX package's result on ``D``
  forced host devices (a subprocess), and the valid prefixes, concatenated,
  equal to ``np.sort``.
* ``sphere_map`` / ``sphere_shuffle`` / ``gather_blocks``: the gathered
  map equals the UDF on the whole array; the exchange equals the
  transpose of blocks.
* ``kmeans_step(mesh=)``: within ``rtol = 1e-5``, ``atol = 1e-6`` of
  ``kmeans_step_jax`` on the concatenated points (the ranks' sums are
  added in another order).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core import kmeans as jkm
from repro.core import shuffle as jsh
from repro.core.records import RecordBatch as JBatch
from repro.core.records import StackedBatch as JStacked
from repro_torch.core import shuffle as tsh
from repro_torch.core.records import RecordBatch, StackedBatch
from repro_torch.launch.mesh import run_ranks

ROOT = Path(__file__).resolve().parents[1]
SIZES = (1, 2, 4)


@pytest.fixture(scope="module")
def suite():
    """One spawn per mesh size, run on first use."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = run_ranks(ranks.spmd_suite, world,
                                    join_timeout_s=300)
        return runs[world]
    return get


def _host_harvest(name):
    """(per-worker bytes, counts, per-slot hist) of the JAX package's
    single-device round and of the port's."""
    c = ranks.ROUND_CASES[name]
    slots = ranks.ragged_round(c["loads"], c["rec"], c["seed"])
    S, W = len(slots), c["W"]
    slot_workers = np.sort(np.arange(S) % W)
    names = [f"s{i}" for i in range(W)]
    out = []
    for sh, batch, stack in (
            (jsh, lambda s: JBatch.from_records(s) if s
             else JBatch.empty(c["rec"]), JStacked),
            (tsh, lambda s: RecordBatch.from_records(s, device="cpu") if s
             else RecordBatch.empty(c["rec"], "cpu"), StackedBatch)):
        part = ranks.partitioner(c, slots, sh)
        stacked = stack.pack([batch(s) for s in slots], pad_block=8)
        res = sh.scatter_round_dispatch(
            stacked, part, c["n"], worker_names=names,
            slot_workers=slot_workers, pad_block=8).harvest()
        data = np.asarray(res.data)
        out.append([data[w, :res.counts[w]].tobytes() for w in range(W)])
        out.append(res.counts.tolist())
    hist = [[ranks.partitioner(c, slots, jsh)(r, c["n"]) for r in s]
            for s in slots]
    hist = np.array([[h.count(b) for b in range(c["n"])] for h in hist])
    return out, hist


@pytest.mark.parametrize("name", sorted(ranks.ROUND_CASES))
@pytest.mark.parametrize("world", SIZES)
def test_fused_scatter_round_matches_host_harvest(suite, world, name):
    (j_parts, j_counts, t_parts, t_counts), hist = _host_harvest(name)
    assert t_parts == j_parts and t_counts == j_counts
    got = {}
    for rank, res in enumerate(suite(world)):
        r = res["rounds"][name]
        assert r["counts"].tolist() == j_counts, f"rank {rank}"
        np.testing.assert_array_equal(r["hist"], hist)
        got.update(r["parts"])
    assert [got[w] for w in range(len(j_parts))] == j_parts


def _jax_sorts(world, tmp_path):
    """The JAX package's distributed_sort / barrier_sort on ``world``
    forced host devices (a subprocess: this process keeps one device)."""
    keys = tmp_path / "keys.npy"
    np.save(keys, ranks.sort_keys(world))
    result = tmp_path / "out.npz"
    code = textwrap.dedent(f"""
        import jax.numpy as jnp, numpy as np
        from repro.core.spmd import barrier_sort, distributed_sort
        from repro.launch.mesh import make_flat_mesh
        mesh = make_flat_mesh()
        keys = jnp.asarray(np.load({str(keys)!r}))
        out, valid = distributed_sort(keys, mesh)
        np.savez({str(result)!r}, out=np.asarray(out),
                 valid=np.asarray(valid),
                 barrier=np.asarray(barrier_sort(keys, mesh)))
    """)
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return np.load(result)


@pytest.mark.parametrize("world", [2, 4])
def test_sorts_match_jax_on_host_devices(suite, world, tmp_path):
    ref = _jax_sorts(world, tmp_path)
    out_blocks = ref["out"].reshape(world, -1)
    bar_blocks = ref["barrier"].reshape(world, -1)
    valid = []
    for rank, res in enumerate(suite(world)):
        srt, v = res["sort"]
        assert srt.dtype == np.uint32 and res["barrier"].dtype == np.uint32
        np.testing.assert_array_equal(srt, out_blocks[rank])
        np.testing.assert_array_equal(v, ref["valid"][rank:rank + 1])
        np.testing.assert_array_equal(res["barrier"], bar_blocks[rank])
        valid.append(srt[:int(v[0])])
    np.testing.assert_array_equal(np.concatenate(valid),
                                  np.sort(ranks.sort_keys(world)))


@pytest.mark.parametrize("world", SIZES)
def test_sphere_map_shuffle_and_gather(suite, world):
    x = (np.arange(world * world * 6, dtype=np.int32)
         .reshape(world * world, 6) * 7919)
    y = x[::-1] + 3
    blocks = x.reshape(world, world, 6)        # [source rank, dest, 6]
    for rank, res in enumerate(suite(world)):
        np.testing.assert_array_equal(res["map"], x * 2 - y)
        np.testing.assert_array_equal(res["shuffle"], blocks[:, rank])
        np.testing.assert_array_equal(res["shuffle_u32"],
                                      blocks[:, rank].view(np.uint32))
        assert res["roundtrip"]


@pytest.mark.parametrize("world", [2, 4])
def test_kmeans_step_mesh_matches_jax(suite, world):
    pts, cents = ranks.km_inputs()
    j_new, j_inertia = jkm.kmeans_step_jax(jnp.asarray(pts),
                                           jnp.asarray(cents))
    for res in suite(world):
        new_c, inertia = res["kmeans"]
        np.testing.assert_allclose(new_c, np.asarray(j_new),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(inertia, float(j_inertia), rtol=1e-5,
                                   atol=1e-6)


def test_single_rank_mesh_and_sub_axis():
    """A collective runs over its axis's own group: an axis of one rank
    is the identity, whatever the other axes; a sub-axis group the mesh
    was not built with raises."""
    from repro_torch.core import spmd
    from repro_torch.parallel.mesh_utils import Mesh, single_device_mesh

    one = single_device_mesh(device="cpu")
    keys = torch.arange(8, dtype=torch.int32).flip(0).view(torch.uint32)
    srt, valid = spmd.distributed_sort(keys, one)
    assert _u32(srt)[:8].tolist() == list(range(8)) and int(valid[0]) == 8
    two = Mesh(("data", "model"), {"data": 1, "model": 2}, object(), 0, 2,
               "cpu", "gloo")
    assert _u32(spmd.barrier_sort(keys, two)).tolist() == list(range(8))
    grid = Mesh(("data", "model"), {"data": 2, "model": 2}, object(), 0, 4,
                "cpu", "gloo")
    with pytest.raises(ValueError, match="make_mesh_compat"):
        spmd.barrier_sort(keys, grid)


def _u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)
