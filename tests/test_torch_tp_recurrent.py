"""The tensor-parallel pieces of the RG-LRU, the xLSTM blocks and the
frontends (ROADMAP item 1.3f part 2), on the CPU.

(a) ``rglru.rank_gate_columns``: at ``model`` sizes of 3, 5 and 16 over a
    width of 240 (gate blocks of 30; slices of 80 and 48 that cross them,
    slices of 15 that share one), each rank's columns from the blocks
    ``rglru.gate_span`` names concatenate to ``block_diag_apply`` on the
    whole input, and to the JAX package's ``block_diag_apply``.
(b) On gloo ranks at ``(data, model) = (1, 3)`` and ``(1, 2)``
    (``torch_train_ranks.tp_recurrent_suite``): ``xlstm.split_rms_norm``
    (the mean square's sums over ``model``) and
    ``sharded.gather_from_model`` (its backward keeps the rank's columns)
    against one process's whole computation, outputs and gradients; and
    each split layer (the RG-LRU, both routes; the mLSTM and sLSTM on 2
    of 4 heads; the vision projector and the audio projection) against
    the whole layer: the output, the input's gradient, each leaf's
    gradient (the rank's block), the new states, in training, a prefill
    and a decode step.  The splits match the JAX package through the
    model-level cases of ``test_torch_mesh_train.py``.
(c) On 5 gloo ranks (``torch_train_ranks.gloo_ring_suite``): gloo's sums,
    which the card's references of more than two ``model`` ranks follow:
    ``chip_smoke.ring_sum`` is each group's all-reduce, and its block
    each rank's reduce-scatter, bit for bit, at 2, 3 and 5 ranks in bf16
    and float32 (where the ranks' sum in rank order is not); and
    ``chip_smoke.emulated_model_ranks`` computes the ``tp`` step of 5 and
    of 2 ranks, loss and gradient, bit for bit.
"""
import numpy as np
import pytest
import torch

import torch_train_ranks as ranks
from repro_torch.launch.mesh import run_ranks

WIDTH = 240
TOL = 1e-5              # of each reference's largest |value| (float32)


@pytest.mark.parametrize("size", [3, 5, 16])
def test_rank_gate_columns_concatenate_to_the_whole_product(size):
    import jax.numpy as jnp

    from repro.models.common import block_diag_apply as jblock_diag_apply
    from repro_torch.models import rglru
    from repro_torch.models.common import block_diag_apply
    rng = np.random.default_rng(size)
    block = WIDTH // rglru.N_GATE_BLOCKS
    x = rng.normal(size=(2, 7, WIDTH)).astype(np.float32)
    w = rng.normal(size=(rglru.N_GATE_BLOCKS, block, block)).astype(
        np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    cols, spans = [], []
    for index in range(size):
        b0, b1 = rglru.gate_span(WIDTH, index, size)
        spans.append((b0, b1))
        part = rglru.rank_gate_columns(tx[..., b0 * block:b1 * block], tw,
                                       index, size)
        assert part.shape == (2, 7, WIDTH // size)
        cols.append(part)
    # each slice's blocks are the fewest that hold it
    n = WIDTH // size
    assert all(b0 * block <= i * n < b0 * block + block
               and (b1 - 1) * block < (i + 1) * n <= b1 * block
               for i, (b0, b1) in enumerate(spans))
    got = torch.cat(cols, -1)
    want = block_diag_apply({"w": tw}, tx)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    jwant = np.asarray(jblock_diag_apply({"w": jnp.asarray(w)},
                                         jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def suite():
    return run_ranks(ranks.tp_recurrent_suite, 3, timeout_s=120,
                     join_timeout_s=300)[0]


@pytest.mark.parametrize("size", [3, 2])
def test_split_rms_norm_sums_the_mean_square_over_model(suite, size):
    """(b) ``xlstm.split_rms_norm`` on rank 0's columns: the rank's
    columns of the whole ``rms_norm``, and the gradients of the input's
    and the scale's columns, which take every rank's loss through the
    summed mean square; one float32 a row summed forward and backward."""
    got = suite[size]["pieces"]["norm"]
    assert max(got["out"], got["x"], got["scale"]) <= TOL, got
    assert got["wire"] == 2 * 2 * 5 * 4


@pytest.mark.parametrize("size", [3, 2])
def test_gather_from_model_keeps_the_rank_block_of_the_gradient(suite,
                                                                size):
    """(b) ``sharded.gather_from_model``: the whole from rank 0's columns,
    and the gradient of those columns is their block of the whole
    computation's (not ``model`` times it), the part's bytes once on the
    wire."""
    got = suite[size]["pieces"]["gather"]
    assert got["out"] == 0 and got["x"] <= TOL, got
    assert got["wire"] == got["part_bytes"]


LAYER_CASES = [(3, "rglru"), (3, "rglru/prefill"), (3, "rglru/decode"),
               (2, "rglru"), (2, "rglru/prefill"), (2, "rglru/decode"),
               (2, "mlstm"), (2, "mlstm/prefill"), (2, "mlstm/decode"),
               (2, "slstm"), (2, "slstm/prefill"), (2, "slstm/decode"),
               (2, "vision"), (2, "audio")]


@pytest.mark.parametrize("size,case", LAYER_CASES, ids=str)
def test_split_layer_matches_the_whole_layer(suite, size, case):
    """(b) A layer on rank 0's blocks against the whole layer: its output,
    its input's gradient (summed over ``model``), each leaf's gradient
    (the rank's block of a split leaf's; the whole of a leaf every rank
    keeps whole: the gates, ``up``, ``r_*``, ``w2``, the sLSTM's norm and
    FFN), and in a prefill or decode step the rank's block of the new
    state."""
    got = suite[size]["layers"][case]
    assert {"out", "x"} <= set(got) and any(k.startswith("grad/")
                                            for k in got)
    if "/" in case:
        assert any(k.startswith("state/") for k in got)
    bad = {k: v for k, v in got.items() if not v <= TOL}
    assert not bad, bad


@pytest.fixture(scope="module")
def ring():
    return run_ranks(ranks.gloo_ring_suite, 5, timeout_s=300,
                     join_timeout_s=600)


@pytest.mark.parametrize("size", ranks.RING_SIZES)
def test_ring_sum_adds_as_gloo_does(ring, size):
    """(c) Every member's all-reduce equals ``chip_smoke.ring_sum`` and
    its reduce-scatter its block of it (where the group divides the
    length), bit for bit, from 30 elements to segments cut at
    ``GLOO_SEGMENT_BYTES``; past two ranks the sum in
    rank order differs, so the check reads the order."""
    seen = 0
    for r in range(size):
        for (s, dtype, n), got in ring[r]["sums"].items():
            if s == size:
                seen += 1
                assert got["all_reduce"] == 0, (r, dtype, n, got)
                assert got.get("reduce_scatter", 0) == 0 and (
                    "reduce_scatter" in got or n % size), (r, dtype, n, got)
    assert seen == size * 2 * len(ranks.RING_LENGTHS)
    if size > 2:
        assert all(got["rank_order"] for (s, _, n), got in
                   ring[0]["sums"].items() if s == size and n > 30)


@pytest.mark.parametrize("size", [5, 2])
def test_emulated_model_ranks_compute_the_tp_step_bit_for_bit(ring, size):
    """(c) The tp step of the RG-LRU whose 5 slices cross its gate blocks
    (and of 2 ranks, whole blocks), bf16, full remat and the fused head:
    the emulation's loss and every gradient leaf equal the mesh's."""
    got = ring[0]["steps"][size]
    assert got["loss"] == got["emulated_loss"], got
    assert len(got["unequal"]) > 30
    bad = {p: c for p, c in got["unequal"].items() if c}
    assert not bad, bad
