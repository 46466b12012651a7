"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, on meta
tensors over stand-in meshes.

* The argument bytes a rank's step holds equal, exactly, XLA's
  ``memory_analysis().argument_size_in_bytes`` of the JAX package's
  ``repro.launch.dryrun.build_cell`` for the same reduced cell (train,
  prefill, decode) lowered and compiled on a ``(2, 2)`` mesh of 4 host
  devices, in a subprocess.
* The FLOPs of ``qwen3-8b`` and ``recurrentgemma-2b`` at ``train_4k`` on
  the 16 x 16 stand-in, per device times 256, within 15% of
  ``benchmarks/analytic.py``'s ``cell_flops`` with the knobs the port
  runs.  Under ``layout="fsdp"`` each of the 256 ranks trains its own row
  on whole layers, so the ranks' counts add up to the step's (under
  ``tp`` the ranks of a ``model`` group repeat what they compute whole:
  the head, K / V whose kv heads do not split).  The analytic
  ``attn_impl="scan"`` counts the full rectangle of pairs in every pass;
  the port's forward and its recompute run the kernel over the live
  pairs (half the rectangle, causal) and its backward recomputes the
  plain version over the full rectangle, which the same model's four
  passes cover within a few percent (``qwen3-8b``: the eight rectangle
  products of the analytic model against the port's 2 x 0.5 x 2 + 6).
* A reduced train step's bytes by collective (``sharded.WIRE``) on
  ``(2, 1)`` and ``(1, 2)`` stand-in meshes, both layouts and the MoE's
  all-to-all, exactly what a real step of 2 gloo ranks hands over, rank
  by rank; and the gathers' and reduce-scatters' bytes on ``(2, 1)``
  exactly a count from the leaf shapes and specs alone.
* The kernels' closed-form costs against loops over their work; the
  meta routes' launches against the CPU route's calls in one step.
* The command line: ``ok`` records (``xlstm-1.3b``'s serving cell and a
  ``vocab_parallel`` one among them, each once refused), a refused one
  (the serving mesh under ``layout="fsdp"``, which the JAX package's
  serve steps refuse too), no default group left behind.
* ``dbrx-132b``'s ``decode_32k`` rank on 16x16: the argument bytes are
  rank 0's blocks by the spec trees, and the weights it serves with hold
  one sixteenth of the experts, all of it under the card's 80 GB.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_train_ranks as ranks
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_mesh_compat, make_production_mesh,
                                     run_ranks)
from repro_torch.parallel.sharding import ParallelConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLOPS_REL = 0.15

# (key, arch, layers (0: the reduced config's), kind, tokens a row, rows):
# each step kind; the decode cell's cache is one recurrentgemma pattern
# unit's RG-LRU states and rings (96 positions past the window of 64)
ARG_CASES = (("train", "qwen2.5-3b", 0, "train", 32, 8),
             ("prefill", "qwen2.5-3b", 0, "prefill", 32, 4),
             ("decode", "recurrentgemma-2b", 13, "decode", 96, 4))

_JAX = """
import json, sys
import jax
jax.devices()   # 4 host devices, before repro.launch.dryrun asks for 512
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import dryrun
from repro.launch.mesh import make_mesh_compat
from repro.parallel.sharding import ParallelConfig
from repro.train import optim
from repro.train.step import to_shardings

mesh = make_mesh_compat((2, 2), ("data", "model"))
out = {}
for key, arch, layers, kind, seq, batch in eval(sys.argv[1]):
    cfg = get_config(arch).reduced()
    if layers:
        cfg = cfg.replace(n_layers=layers)
    shape = ShapeConfig(key, seq_len=seq, global_batch=batch, kind=kind)
    pcfg = ParallelConfig(mesh=mesh)
    fn, args, ins, outs, donate = dryrun.build_cell(
        cfg, shape, pcfg, optim.AdamWConfig())
    with jax.set_mesh(mesh):
        compiled = jax.jit(
            fn, in_shardings=to_shardings(ins, mesh),
            out_shardings=None if outs is None else to_shardings(outs, mesh),
            donate_argnums=donate).lower(*args).compile()
    out[key] = int(compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_arguments():
    """The JAX package's argument bytes of ``ARG_CASES``, compiled in a
    subprocess that starts with the module and runs beside its tests."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), repr(ARG_CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            box["out"] = json.loads(out.strip().splitlines()[-1])
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ------------------------------------------------------------ kernel costs
def _live_loop(T, S, causal, window):
    n = 0
    for t in range(T):
        hi = min(t + 1, S) if causal else S
        lo = max(0, t - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


@pytest.mark.parametrize("causal", [True, False])
def test_live_pairs_closed_form_equals_the_loop(causal):
    from repro_torch.kernels.flash_attention.cost import flash_cost, \
        live_pairs
    for T in (0, 1, 2, 3, 7, 16, 31, 64, 65, 130):
        for S in (0, 1, 5, 16, 64, 65, 129, 200):
            for window in (0, 1, 2, 7, 16, 64, 100, 300):
                want = _live_loop(T, S, causal, window)
                assert live_pairs(T, S, causal, window) == want, \
                    (T, S, causal, window)
    # a launch: 4 D operations a head and pair; q, k, v read, o written
    ops, n = flash_cost((2, 48, 6, 32), (2, 40, 3, 32), 2, causal, 16)
    assert ops == 4 * 32 * 6 * 2 * _live_loop(48, 40, causal, 16)
    assert n == (2 * 2 * 48 * 6 * 32 + 2 * 2 * 40 * 3 * 32) * 2


def test_scan_cost_is_its_reads_and_writes():
    from repro_torch.kernels.rg_lru_scan.cost import scan_cost
    a = torch.empty(3, 17, 40)
    ops, n = scan_cost(a.shape)
    assert ops == 2 * a.numel()
    assert n == (3 * a.numel() + 2 * 3 * 40) * 4


def test_meta_routes_launch_where_the_cpu_route_calls():
    """One reduced ``recurrentgemma-2b`` train step: the meta routes'
    launches (forward, recompute, the scan's time-reversed backward)
    equal the plain routes' calls of the same step on the CPU, and bump
    the kernels' own counters as the card's launches do."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rg_lru_scan import kernel as lkernel
    from repro_torch.kernels.rg_lru_scan import ops as lops
    from repro_torch.models import model
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    cfg = get_config("recurrentgemma-2b").reduced()
    pcfg = ParallelConfig(mesh=None)
    calls = {"flash_attention": 0, "rg_lru_scan": 0,
             "rg_lru_scan_backward": 0}
    forward, scan = fops._forward, lops._scan

    def count_forward(*a, **kw):
        calls["flash_attention"] += 1
        return forward(*a, **kw)

    def count_scan(*a, backward):
        calls["rg_lru_scan_backward" if backward else "rg_lru_scan"] += 1
        return scan(*a, backward=backward)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ocfg = optim.AdamWConfig()
    batch = {"inputs": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    step = tstep.make_train_step(cfg, pcfg, ocfg, optim.warmup_cosine(
        1e-3, 1, 10))
    fops._forward, lops._scan = count_forward, count_scan
    try:
        step(params, optim.init_state(params, ocfg), batch)
    finally:
        fops._forward, lops._scan = forward, scan
    before = (fkernel.launches, lkernel.launches, lkernel.backward_launches)
    rec = dryrun.count_step(cfg, ShapeConfig("t", 16, 2, "train"), pcfg)
    got = {k: v["launches"] for k, v in rec["kernels"].items()}
    assert got == calls and calls["rg_lru_scan_backward"] > 0
    assert (fkernel.launches - before[0], lkernel.launches - before[1],
            lkernel.backward_launches - before[2]) == tuple(
                calls[k] for k in ("flash_attention", "rg_lru_scan",
                                   "rg_lru_scan_backward"))


# ------------------------------------------------------------ FLOPs
@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-2b"])
def test_flops_match_the_analytic_model(arch):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmarks.analytic import Knobs, cell_flops
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    with dryrun.standin_group(256):
        mesh = make_production_mesh(device="meta")
        rec = dryrun.count_step(get_config(arch), SHAPES["train_4k"],
                                ParallelConfig(mesh=mesh, layout="fsdp"))
    # the port's knobs: full remat, the head unfused
    want = cell_flops(jget_config(arch), JSHAPES["train_4k"],
                      Knobs(remat="full", fused_head=False,
                            attn_impl="scan"))["total"]
    got = rec["cost"]["flops"] * 256
    assert abs(got / want - 1) <= FLOPS_REL, (got, want)
    assert not dist.is_initialized()


def test_counter_takes_the_cards_in_place_gradient_routes():
    """A tied table looked up and narrowed for a head, on meta under the
    dry run's counter: the lookup's backward writes its zeros in place and
    autograd adds the head's gradient of the table to that buffer in
    place, as they run on the card (under a dispatch mode autograd takes
    the out-of-place branches, a table more each): three tables live at
    the peak (the forward's table, the head's gradient, the lookup's),
    not five; ``by_line`` names the backward nodes that made them."""
    rows, width = 1024, 64
    table = rows * width * 2
    w0 = torch.zeros(rows, width, dtype=torch.bfloat16, device="meta",
                     requires_grad=True)
    idx = torch.tensor([[1, 5, 7]], device="meta")
    with dryrun.Counter(by_line=True) as c, torch.enable_grad():
        w = w0 * 1
        x = w[idx]
        (x @ w.narrow(0, 0, rows // 2).t()).float().sum().backward()
    assert 3 * table <= c.peak < 3.5 * table    # and a few small ones
    lines = {line for line, n in c.peak_lines.items() if n >= table}
    assert lines == {"elsewhere", "backward SliceBackward0",
                     "backward IndexBackward0"}, c.peak_lines


# ------------------------------------------------------------ collectives
def test_collective_bytes_equal_a_real_two_rank_step():
    """``torch_train_ranks.DRYRUN_WIRE_CASES`` on 2 gloo ranks and on the
    stand-in meshes: every ``sharded.WIRE`` key, byte for byte, of each
    rank (the dry run counts rank 0's; the ranks are symmetric)."""
    real = run_ranks(ranks.dryrun_wire_suite, 2, timeout_s=300,
                     join_timeout_s=600)
    for arch, shape, layout, dispatch in ranks.DRYRUN_WIRE_CASES:
        with dryrun.standin_group(2):
            mesh = make_mesh_compat(shape, ("data", "model"), device="meta")
            pcfg = ParallelConfig(mesh=mesh, remat="none", layout=layout,
                                  moe_dispatch=dispatch)
            rec = dryrun.count_step(ranks.lm_cfg(arch), ShapeConfig(
                "t", ranks.T, ranks.B, "train"), pcfg)
        got = rec["collectives"]["wire"]
        for rank, out in enumerate(real):
            want = out[arch, shape, layout]
            assert sum(want.values()) > 0
            assert {k: got[k] for k in want} == want, (arch, shape, layout,
                                                       rank)
        assert rec["collectives"]["total"] >= sum(want.values())


@pytest.mark.parametrize("arch,remat", [("qwen2.5-3b", "none"),
                                        ("qwen2.5-3b", "full"),
                                        ("recurrentgemma-2b", "full")])
def test_gather_and_reduce_scatter_bytes_follow_the_leaf_shapes(arch,
                                                                remat):
    """A count of the bytes independent of the port's ``sharded.WIRE``,
    from the leaf shapes and specs alone, for a reduced train step on the
    ``(2, 1)`` stand-in (one microbatch): a leaf split over ``data`` is
    gathered as its block, once, or, in the stack under full remat,
    again in the recompute; every leaf's gradient is summed over ``data``
    (a split leaf's reduce-scattered, a whole leaf's all-reduced, both
    counted under ``reduce_scatter``) at the whole leaf's bytes."""
    from repro_torch.models import model
    from repro_torch.parallel.sharding import param_specs_for
    from repro_torch.utils.pytree import tree_flatten_with_paths
    cfg = ranks.lm_cfg(arch)
    shapes = model.param_shapes(cfg)
    with dryrun.standin_group(2):
        mesh = make_mesh_compat((2, 1), ("data", "model"), device="meta")
        pcfg = ParallelConfig(mesh=mesh, remat=remat, layout="tp")
        rec = dryrun.count_step(cfg, ShapeConfig(
            "t", ranks.T, ranks.B, "train"), pcfg)
        specs = dict(tree_flatten_with_paths(param_specs_for(shapes, pcfg)))
    gather = scatter = 0
    for path, leaf in tree_flatten_with_paths(shapes):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        if "data" in specs[path]:
            passes = 2 if remat == "full" and path.startswith("blocks/") \
                else 1
            gather += n // 2 * passes
        scatter += n
    wire = rec["collectives"]["wire"]
    assert gather > 0
    assert (wire["gather"], wire["reduce_scatter"]) == (gather, scatter)


# ------------------------------------------------------------ arguments
@pytest.mark.parametrize("key", [c[0] for c in ARG_CASES])
def test_argument_bytes_equal_the_jax_memory_analysis(jax_arguments, key):
    _, arch, layers, kind, seq, batch = [c for c in ARG_CASES
                                         if c[0] == key][0]
    cfg = get_config(arch).reduced()
    if layers:
        cfg = cfg.replace(n_layers=layers)
    with dryrun.standin_group(4):
        mesh = make_mesh_compat((2, 2), ("data", "model"), device="meta")
        rec = dryrun.count_step(cfg, ShapeConfig(key, seq, batch, kind),
                                ParallelConfig(mesh=mesh))
    assert rec["memory"]["argument_bytes"] == jax_arguments()[key]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


# ------------------------------------------------------------ the CLI
def test_command_line_records_ok_and_refused_cells(tmp_path):
    """In a subprocess: cells the port runs write ``ok: true`` (the
    ``xlstm-1.3b`` serving cell, one decode step over whole states, and
    one under ``--knob embed_mode=vocab_parallel``, each once refused);
    a serving cell under ``--knob layout=fsdp`` writes ``ok: false``,
    refused as the JAX package's own serve steps refuse it (its
    ``cache_specs_for`` raises ``DuplicateSpecError``; the summary counts
    it refused, not failed); no default group is left behind."""
    code = textwrap.dedent(f"""
        import torch.distributed as dist
        from repro_torch.launch import dryrun
        out = {str(tmp_path)!r}
        rcs = [dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                            "--out-dir", out]),
               dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k",
                            "--out-dir", out]),
               dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                            "--knob", "layout=fsdp", "--tag", "fsdp",
                            "--out-dir", out]),
               dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                            "--knob", "embed_mode=vocab_parallel",
                            "--tag", "vp", "--out-dir", out])]
        assert not dist.is_initialized()
        print("RCS", rcs)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ,
                               "PYTHONPATH": os.path.join(ROOT, "src")},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "RCS [0, 0, 0, 0]" in proc.stdout
    assert proc.stdout.count("1/1 cells OK, 0 refused, 0 failed") == 3
    assert proc.stdout.count("1 refused (1 as the reference), 0 failed") \
        == 1
    ok = json.loads((tmp_path / "qwen2.5-3b__decode_32k__16x16.json")
                    .read_text())
    assert ok["ok"] and ok["error"] is None
    assert ok["memory"]["argument_bytes"] > 0 and ok["cost"]["flops"] > 0
    assert set(ok["collectives"]) >= {"all-gather", "all-reduce", "total",
                                      "cross_pod", "intra_pod",
                                      "intra_node", "inter_node"}
    xl = json.loads((tmp_path / "xlstm-1.3b__decode_32k__16x16.json")
                    .read_text())
    assert xl["ok"] and xl["error"] is None and xl["refused"] is None
    assert xl["memory"]["serving_bytes"] >= xl["memory"]["argument_bytes"]
    refused = json.loads(
        (tmp_path / "qwen2.5-3b__decode_32k__16x16__fsdp.json").read_text())
    assert not refused["ok"] and refused["refused"] == "reference"
    assert "DuplicateSpecError" in refused["error"]
    assert refused["knobs"] == {"layout": "fsdp"}
    vp = json.loads(
        (tmp_path / "qwen2.5-3b__decode_32k__16x16__vp.json").read_text())
    assert vp["ok"] and vp["error"] is None and vp["refused"] is None
    assert vp["knobs"] == {"embed_mode": "vocab_parallel"}
    # the table's rows a rank serves with: a sixteenth of the vocabulary
    assert vp["memory"]["serving_bytes"] < ok["memory"]["serving_bytes"]


def test_dbrx_serving_rank_holds_its_experts_block():
    """``dbrx-132b``'s ``decode_32k`` cell on the 16 x 16 stand-in mesh,
    its step not run: ``argument_bytes`` equals rank 0's blocks of the
    parameters, the cache and the batch counted here leaf by leaf from
    the spec trees (each dim over the product of its axes); the weights
    the rank serves with (``serve_params``) keep one sixteenth of each
    expert leaf (its ``model`` block, whole over ``data``: 1 of 16
    experts), and those with the cache's block stay under 80 GB."""
    from repro_torch.models import model as tmodel
    from repro_torch.models.inputs import input_specs
    from repro_torch.parallel.sharding import param_specs_for
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    from repro_torch.utils.pytree import tree_flatten_with_paths as flat
    from repro_torch.utils.pytree import tree_leaves
    cfg, shape = get_config("dbrx-132b"), SHAPES["decode_32k"]

    def rank0(shapes, specs, sizes):
        total = 0
        for s, spec in zip(tree_leaves(shapes), tree_leaves(specs)):
            n = s.dtype.itemsize
            for d, dim in enumerate(s.shape):
                axes = spec[d] if d < len(spec) else None
                axes = () if axes is None else \
                    (axes if isinstance(axes, tuple) else (axes,))
                n *= dim // math.prod(sizes[a] for a in axes)
            total += n
        return total

    with dryrun.standin_group(256):
        mesh = make_production_mesh(multi_pod=False, device="meta")
        pcfg = ParallelConfig(mesh=mesh)
        sizes = dict(mesh.shape)
        cell = dryrun.build_cell(cfg, shape, pcfg, optim.AdamWConfig())
        with torch.inference_mode():
            served = dict(flat(cell["setup"]()))
    pshapes = tmodel.param_shapes(cfg)
    ctree = tmodel.cache_shapes(cfg, shape.global_batch, shape.seq_len)
    btree = input_specs(cfg, shape)
    want = rank0(pshapes, param_specs_for(pshapes, pcfg), sizes) \
        + rank0(ctree, tstep.cache_specs_for(ctree, pcfg, cfg), sizes) \
        + rank0(btree, tstep.batch_specs_for(btree, pcfg), sizes)
    assert cell["argument_bytes"] == want
    whole = dict(flat(pshapes))
    experts = [p for p in whole if "/moe/w" in p]
    assert len(experts) == 3
    for path in experts:
        assert served[path].numel() * 16 == math.prod(whole[path].shape)
        assert served[path].shape[1] == cfg.n_experts // 16
    cache = rank0(ctree, tstep.cache_specs_for(ctree, pcfg, cfg), sizes)
    serving = sum(x.nbytes for x in served.values()) + cache
    assert serving < 80e9, serving


def test_standin_group_refuses_a_default_group_and_leaves_none(tmp_path):
    """The stand-in group will not start beside an existing default
    group; a cell that fails (an unknown knob, named) is recorded and
    leaves no group behind."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            with dryrun.standin_group(4):
                pass
    finally:
        dist.destroy_process_group()
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", multi_pod=False,
                          knobs={"bogus": 1}, save=False)
    assert not rec["ok"] and rec["refused"] is None
    assert "'bogus'" in rec["error"]
    assert not dist.is_initialized()
    assert np.isfinite(rec["wall_s"])
