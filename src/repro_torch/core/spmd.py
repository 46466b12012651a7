"""Sphere-on-SPMD: the paper's stage/shuffle model on ``torch.distributed``.

The port of ``repro.core.spmd``.  A Sphere stage is an
embarrassingly-parallel UDF over the chunks resident on each node; the
Sphere shuffle is an all-to-all exchange.  The JAX package writes both as
``shard_map`` bodies over the mesh's ``data`` axis, driven by one
controller.  ``torch.distributed`` runs one process per rank instead, so
this module translates by one rule:

    Whatever the JAX package computes **outside** a ``shard_map`` body,
    every rank computes whole: a replicated value.  Whatever it computes
    **inside** a body, rank ``r`` computes on its own block: the
    ``P("data")`` shard that device ``r`` would hold.

    Going from sharded to replicated is an ``all_gather``
    (:func:`gather_blocks`).  Going from replicated to sharded is a local
    slice, with no communication (:func:`local_block`).

Every rank therefore runs the same program from the same seed, and host
metadata (plans, valid counts, histograms) is identical on every rank;
the functions here take and return **rank-local blocks**.  A block is
the leading-axis slice ``[r * n / D, (r + 1) * n / D)`` of the global
array, ``D`` the size of the ``data`` axis.

Collectives run over the process group of their axis
(``Mesh.group_for``): on a 2-D mesh the ``data`` ranks of one ``model``
coordinate exchange, and the other coordinates repeat the same work.
On a gloo group whose
ranks keep their tensors on a GPU (several ranks sharing one card, where
NCCL refuses), the collective copies to the host and back
(``Mesh.host_staged``); gloo carries no ``uint32``, so 32-bit keys cross
as an ``int32`` bit view.  A mesh without a process group has one rank,
and its collectives are the identity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.records import StackedBatch
from repro_torch.core.shuffle import _kernel_partition
from repro_torch.parallel.mesh_utils import Mesh

SENTINEL = 0xFFFFFFFF


# ------------------------------------------------------------ collectives
def _axis_size(mesh: Mesh, axis: str) -> int:
    """Ranks along ``axis``; its collectives run over the axis's own
    process group (``Mesh.group_for``), so the data plane runs on the
    ``data`` axis of a 2-D or 3-D mesh as on a 1-D one."""
    return mesh.shape[axis]


def _to_wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.contiguous().cpu() if mesh.host_staged else x.contiguous()


def _from_wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.to(mesh.device) if mesh.host_staged else x


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Block ``j`` of the leading axis goes to rank ``j`` of ``axis``;
    block ``j`` of the result came from rank ``j`` (``lax.all_to_all``
    tiled over axis 0)."""
    group = mesh.group_for(axis)
    if group is None:
        return x
    src = _to_wire(x, mesh)
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=group)
    return _from_wire(dst, mesh)


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated along axis 0, in
    rank order (``lax.all_gather`` tiled)."""
    group = mesh.group_for(axis)
    if group is None:
        return x
    src = _to_wire(x, mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.axes_size(axis))]
    dist.all_gather(parts, src, group=group)
    return _from_wire(torch.cat(parts), mesh)


def host_gather(values, mesh: Mesh) -> list:
    """Every rank's int64 ``values`` in rank order, exchanged on the host
    over ``mesh.host_group``: no device tensor, no stream sync."""
    mine = torch.as_tensor(values, dtype=torch.int64).reshape(-1)
    if mesh.group is None:
        return [mine.tolist()]
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.host_group)
    return [p.tolist() for p in parts]


def host_gather_axis(values, mesh: Mesh, axis: str = "data") -> list:
    """:func:`host_gather` kept to the ranks that differ from this one
    only along ``axis``, in ``axis`` order: entry ``d`` is the values of
    the rank at coordinate ``d`` (the other axes' ranks repeat the same
    work)."""
    every = host_gather(values, mesh)
    names = mesh.axis_names
    stride = math.prod(mesh.shape[a] for a in names[names.index(axis) + 1:])
    r = mesh.axis_index(axis)
    return [every[mesh.rank + (d - r) * stride]
            for d in range(mesh.shape[axis])]


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Elementwise sum of ``x`` over the ranks of ``axis``
    (``lax.psum``)."""
    group = mesh.group_for(axis)
    if group is None:
        return x
    buf = _to_wire(x, mesh).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(buf, mesh)


def _u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or its int32 bit view) as int64 values in [0, 2**32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _i64_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as the int32 bit view of their uint32."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def local_block(x, mesh: Mesh, axis: str = "data"):
    """This rank's block of a replicated ``x`` along its leading axis (a
    view of a tensor, an array or a list; no communication)."""
    d, r = mesh.shape[axis], mesh.axis_index(axis)
    if len(x) % d:
        raise ValueError(f"leading axis {len(x)} does not divide over {d} "
                         f"ranks")
    k = len(x) // d
    return x[r * k:(r + 1) * k]


def gather_blocks(x: torch.Tensor, mesh: Mesh, axis: str = "data"
                  ) -> torch.Tensor:
    """The replicated array whose blocks the ranks hold (every rank's
    ``x`` in rank order)."""
    _axis_size(mesh, axis)
    if x.dtype == torch.uint32:
        return _all_gather(x.view(torch.int32), mesh, axis) \
            .view(torch.uint32)
    return _all_gather(x, mesh, axis)


# ----------------------------------------------------- sharded stacks
@dataclass(frozen=True)
class ShardedStackedBatch(StackedBatch):
    """Rank ``r``'s block of a stacked round.

    ``data`` holds slots ``[r * S / D, (r + 1) * S / D)`` of a round of
    ``S`` global slots (``S`` a multiple of the ``data`` axis size ``D``);
    ``n_valid`` is the HOST ``[S]`` vector of every slot's real rows,
    identical on every rank.  ``n_slots``, ``num_records`` and ``nbytes``
    describe the whole round; :meth:`slot` and :meth:`unpack` read the
    replicated round, gathered once (a collective: every rank reaches it
    at the same point, since every rank runs the same program).
    """

    mesh: Mesh
    _full: list = field(default_factory=list, init=False, repr=False,
                        compare=False)

    def __post_init__(self):
        if self.data.ndim != 3:
            raise ValueError(f"StackedBatch data must be 3-D, "
                             f"got shape {tuple(self.data.shape)}")
        d = self.mesh.shape["data"]
        nv = np.asarray(self.n_valid, dtype=np.int32)
        if nv.shape != (self.data.shape[0] * d,):
            raise ValueError(f"n_valid shape {nv.shape} != "
                             f"({self.data.shape[0]} x {d} ranks,)")
        if nv.size and (int(nv.min()) < 0
                        or int(nv.max()) > self.data.shape[1]):
            raise ValueError(f"n_valid outside [0, {self.data.shape[1]}]")
        object.__setattr__(self, "n_valid", nv)

    @property
    def n_slots(self) -> int:
        return len(self.n_valid)

    @property
    def local_n_valid(self) -> np.ndarray:
        """Real rows of this rank's slots."""
        return local_block(self.n_valid, self.mesh)

    def replicated(self) -> StackedBatch:
        """The whole round on every rank (gathered on first use)."""
        if not self._full:
            self._full.append(StackedBatch(gather_blocks(self.data, self.mesh),
                                           self.n_valid))
        return self._full[0]

    def slot(self, i: int):
        return self.replicated().slot(i)


# ------------------------------------------------------------ stages
def sphere_map(udf: Callable, mesh: Mesh, axis: str = "data"):
    """Lift a per-shard UDF into a distributed Sphere stage.

    Variadic: every argument (and the result) is this rank's block along
    the leading axis, so the stage is ``udf`` itself, applied by each
    rank to its blocks; only the axis is checked.  (The engine's fused
    stage apply calls its vmapped UDF on the rank's block directly.)"""
    _axis_size(mesh, axis)
    return udf


def sphere_shuffle(x: torch.Tensor, bucket_of_shard: Callable, mesh: Mesh,
                   axis: str = "data") -> torch.Tensor:
    """all_to_all exchange of this rank's ``[D * k, cap, ...]`` send
    buffer: block ``i`` of the leading axis goes to rank ``i``.
    ``bucket_of_shard`` is the reference's parameter, unused there as
    here: the send buffer is already laid out by destination."""
    _axis_size(mesh, axis)
    if x.dtype == torch.uint32:
        return _all_to_all(x.view(torch.int32), mesh, axis) \
            .view(torch.uint32)
    return _all_to_all(x, mesh, axis)


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows [m, width]`` uint8 gathered at ``idx``, moved as int32 words
    where the layout allows."""
    width = rows.shape[1]
    if width % 4 == 0 and rows.is_contiguous() \
            and rows.storage_offset() % 4 == 0:
        return rows.view(torch.int32).index_select(0, idx) \
            .view(torch.uint8)
    return rows.index_select(0, idx)


def fused_scatter_round(data: torch.Tensor, n_valids, bounds, *, key_spec,
                        n_buckets: int, n_workers: int, mesh: Mesh,
                        axis: str = "data"):
    """The engine's fused shuffle round on one rank: the key read and
    bucket ids by the ``bucket_partition_rows`` kernel, the exchange as
    ``all_to_all_single``, and the regrouping onto destination workers on
    the device — the multi-rank twin of the single-device
    ``scatter_round_dispatch`` harvest, sharing its record ordering
    contract exactly.

    ``data`` is this rank's block of the engine's stacked round, uint8
    ``[S / D, rows, width]`` (slots ordered worker-major), and
    ``n_valids`` its ``[S / D]`` valid counts.  ``n_workers`` must divide
    by ``D``; worker ``w`` lives on rank ``w // (n_workers / D)`` and owns
    buckets ``{b : b % n_workers == w}``.  ``bounds`` are the
    partitioner's boundary words, ``key_spec`` its static key spec.

    Returns ``(parts, counts, hist_sb)``:

    * ``parts`` uint8 ``[n_workers / D, cap, width]`` — this rank's
      workers' regrouped partitions: their buckets ascending, records
      within a bucket in (slot-major, then input) order.  ``cap`` is the
      fixed exchange capacity, ``D`` times the local rows; tails are
      junk.
    * ``counts`` int32 ``[n_workers]`` — the valid prefix of every
      worker's partition, on every rank.
    * ``hist_sb`` int32 ``[S, n_buckets]`` — every slot's histogram, on
      every rank: the one metadata array the executor syncs.

    The send buffer is packed with one stable sort by (destination rank,
    bucket), with an int32 bucket sidecar (−1 = empty) exchanged beside
    the rows, so the receiver regroups with one stable sort by (local
    worker, bucket) and no second metadata exchange.
    """
    D = _axis_size(mesh, axis)
    r = mesh.axis_index(axis)
    if n_workers % D:
        raise ValueError(f"fused_scatter_round needs n_workers ({n_workers}) "
                         f"divisible by the mesh size ({D})")
    s_l, rows, width = data.shape
    n, W, wpd = n_buckets, n_workers, n_workers // D
    dev = data.device
    m = s_l * rows
    flat = data.reshape(m, width)
    ids, _ = _kernel_partition(flat, key_spec, bounds, n)
    ids = ids.to(torch.int64)
    pos = torch.arange(m, device=dev)
    slot = pos // rows
    nv = torch.as_tensor(np.asarray(n_valids), dtype=torch.int64, device=dev)
    valid = (pos % rows) < nv[slot]
    vi = valid.to(torch.int64)
    hist_sb = torch.zeros(s_l * n, dtype=torch.int64, device=dev) \
        .index_add_(0, slot * n + ids, vi).view(s_l, n)
    # --- sender: rows sorted by (destination rank, bucket), stable; the
    # section of rank e is rows [start_e, start_e + count_e) of that order
    e = (ids % W) // wpd
    skey = torch.where(valid, e * (n + 1) + ids, D * (n + 1))  # invalid last
    order = torch.argsort(skey, stable=True)
    sec_count = torch.zeros(D, dtype=torch.int64, device=dev) \
        .index_add_(0, e, vi)
    sec_start = torch.cumsum(sec_count, 0) - sec_count
    live = pos[None, :] < sec_count[:, None]                    # [D, m]
    take = order[(sec_start[:, None] + pos[None, :]).clamp_max(m - 1)]
    send = _take_rows(flat, take.reshape(-1)).view(D, m, width)
    meta = torch.where(live, ids[take], -1).to(torch.int32)
    recv = _all_to_all(send, mesh, axis)
    rmeta = _all_to_all(meta, mesh, axis)
    # --- receiver: one stable sort by (local worker, bucket); source
    # sections arrive rank-major, so ties keep slot-major input order
    n2 = D * m
    rb = rmeta.reshape(n2).to(torch.int64)
    rv = rb >= 0
    lw = torch.where(rv, (rb % W) - r * wpd, 0)
    rkey = torch.where(rv, lw * (n + 1) + rb, wpd * (n + 1))
    rorder = torch.argsort(rkey, stable=True)
    wcount = torch.zeros(wpd, dtype=torch.int64, device=dev) \
        .index_add_(0, lw, rv.to(torch.int64))
    wstart = torch.cumsum(wcount, 0) - wcount
    q = torch.arange(n2, device=dev)
    take2 = rorder[(wstart[:, None] + q[None, :]).clamp_max(n2 - 1)]
    parts = _take_rows(recv.reshape(n2, width), take2.reshape(-1)) \
        .view(wpd, n2, width)
    # counts and histograms of every rank, in one gather
    mine = torch.cat([wcount, hist_sb.reshape(-1)]).to(torch.int32)
    every = _all_gather(mine, mesh, axis).view(D, wpd + s_l * n)
    return (parts, every[:, :wpd].reshape(W),
            every[:, wpd:].reshape(D * s_l, n))


# ---------------------------------------------------------------------------
# Distributed sort (TeraSort) — sample, bucketize, all_to_all, local sort
# ---------------------------------------------------------------------------

def distributed_sort(keys: torch.Tensor, mesh: Mesh, axis: str = "data",
                     oversample: int = 4):
    """Sort uint32 keys held in blocks over ``axis``.

    ``keys`` is this rank's block.  Returns ``(sorted_padded, valid)``:
    this rank's ascending keys padded with ``SENTINEL`` (uint32, ``D * 2m``
    of them for ``m`` local keys) and ``valid`` (int32 ``[1]``) the count
    of real keys.  The global order is the concatenation of the ranks'
    valid prefixes in rank order.
    """
    D = _axis_size(mesh, axis)
    local = _u32_to_i64(keys.reshape(-1))
    m = local.shape[0]
    cap = 2 * m  # bucket capacity (skew headroom)

    # --- stage 1 (sample UDF): boundary estimation --------------------------
    samp_n = min(D * oversample, m)
    stride = max(m // samp_n, 1)
    samples = torch.sort(local).values[::stride][:samp_n]
    all_samples = _u32_to_i64(_all_gather(_i64_to_i32(samples), mesh,
                                          axis))
    ssorted = torch.sort(all_samples).values
    step = ssorted.shape[0] // D
    bounds = ssorted[step::step][:D - 1].contiguous()

    # --- shuffle: bucketize + fixed-capacity all_to_all ---------------------
    bucket = torch.searchsorted(bounds, local, right=True)
    order = torch.argsort(bucket, stable=True)
    sk, sb = local[order], bucket[order]
    count = torch.zeros(D, dtype=torch.int64, device=local.device) \
        .index_add_(0, bucket, torch.ones_like(bucket))
    pos = torch.arange(m, device=local.device) \
        - (torch.cumsum(count, 0) - count)[sb]          # < m <= cap
    send = torch.full((D, cap), SENTINEL, dtype=torch.int64,
                      device=local.device)
    send.index_put_((sb, pos), sk)
    recv = _u32_to_i64(_all_to_all(_i64_to_i32(send), mesh, axis))

    # --- stage 2 (sort UDF): local sort of the owned bucket ------------------
    flat = recv.reshape(-1)
    out = torch.sort(flat).values
    valid = (flat != SENTINEL).sum().to(torch.int32)
    return _i64_to_i32(out).view(torch.uint32), valid[None]


def barrier_sort(keys: torch.Tensor, mesh: Mesh, axis: str = "data"
                 ) -> torch.Tensor:
    """Hadoop-style comparison point: gather everything to every rank,
    sort, keep your slice — the no-locality, all-data-moves baseline."""
    D = _axis_size(mesh, axis)
    allk = _u32_to_i64(_all_gather(keys.reshape(-1).view(torch.int32), mesh,
                                   axis))
    ssorted = torch.sort(allk).values
    m = ssorted.shape[0] // D
    r = mesh.axis_index(axis)
    return _i64_to_i32(ssorted[r * m:(r + 1) * m]).view(torch.uint32)
