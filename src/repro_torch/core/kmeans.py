"""Distributed k-means as a chain of Sphere jobs (paper §5.3, Table 2).

The port of ``repro.core.kmeans``.  Angle's per-pcap clustering:
aggregate packet data by source entity, compute feature points, cluster
with k-means.  Each iteration is one two-stage Sphere job:

  stage "assign" (UDF, runs where the chunks live): assign each local point
      to the nearest centroid; emit ONE per-centroid (sums ++ counts)
      partial record per task;
  shuffle: partials all go to bucket 0 (``reduce_partitioner`` — the array
      path computes ids/hist directly, no per-record host loop);
  stage "fold" (UDF on the bucket-0 worker): fold the partial records into
      one (sums ++ counts) record; the host turns it into new centroids.

Iterations run through one :class:`SphereSession`: the Sector lookup,
replica placement and fetched chunks are reused, and both stage UDFs are
**mask-aware reductions** — the executor pads each task to a fixed block
shape and passes a validity mask plus the stage's current ``params`` (the
centroids, a float32 tensor on the engine's device), so each stage runs
at one block shape for the whole chain (``SphereReport.udf_traces == 1``).
``session=False`` keeps the re-plan-every-iteration path as the
comparison baseline.

On the array backend the assign stage reaches the hand-written CUDA
kernel through ``kmeans_partials`` when the points are on the card: one
pass over the points gives the task's sums and counts.
:func:`kmeans_step` is the reference's ``kmeans_step_jax``, on one device
or, with a ``mesh``, over the ranks' blocks of points.  On a mesh engine
``kmeans_sphere`` and ``StreamingKMeans`` need nothing of their own: each
rank fetches and assigns only the chunks of its own slots of the plan,
the tasks' partial records are all-gathered over ``data`` in plan order,
and the reduce fold runs replicated on every rank, so the centroids are
bit-identical to the meshless run's.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import SphereEngine, SphereReport, SphereSession
from repro_torch.core.job import SphereJob, SphereStage
from repro_torch.core.records import RecordBatch, f32_view
from repro_torch.core.shuffle import reduce_partitioner
from repro_torch.core.spmd import psum
from repro_torch.core.trace import NULL_TRACER
from repro_torch.kernels.kmeans_assign import kmeans_partials
from repro_torch.parallel.mesh_utils import Mesh


# --------------------------- record codecs ---------------------------------

def encode_points(pts: np.ndarray) -> bytes:
    """float32 points [N, D] -> fixed-size records."""
    return pts.astype("<f4").tobytes()


def decode_points(blob: bytes, dim: int) -> np.ndarray:
    return np.frombuffer(blob, "<f4").reshape(-1, dim)


def _encode_partial(sums: np.ndarray, counts: np.ndarray) -> bytes:
    k, d = sums.shape
    return struct.pack("<II", k, d) + sums.astype("<f8").tobytes() + \
        counts.astype("<i8").tobytes()


def _decode_partial(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    k, d = struct.unpack("<II", blob[:8])
    off = 8
    sums = np.frombuffer(blob[off:off + 8 * k * d], "<f8").reshape(k, d)
    off += 8 * k * d
    counts = np.frombuffer(blob[off:off + 8 * k], "<i8")
    return sums.copy(), counts.copy()


# --------------------------- Sphere stages ---------------------------------
# Array-backend partial record: ONE row of 4*k*(dim+1) bytes holding
# float32 [k, dim+1] = per-centroid sums ++ counts.

def _partial_width(k: int, dim: int) -> int:
    return 4 * k * (dim + 1)


def _f32_rows(batch: RecordBatch) -> torch.Tensor:
    """Reinterpret a batch's rows as little-endian float32."""
    return f32_view(batch.data)


def _f32_record(row: torch.Tensor) -> RecordBatch:
    """float32 [1, m] -> a one-record batch of 4*m bytes."""
    return RecordBatch(row.contiguous().view(torch.uint8).reshape(1, -1))


def make_kmeans_stages(dim: int, k: int, backend: str) -> List[SphereStage]:
    """The assign+fold stage pair, built ONCE per chain.  Feed each
    iteration's centroids through ``stages[0].params`` (array: a float32
    [k, dim] tensor on the engine's device; bytes: a numpy array read by
    the closure) — the mask-aware UDFs take params as an argument, so
    updating them never changes the stage's block shape."""
    if backend == "array":
        def assign_masked(batch: RecordBatch, mask, c) -> RecordBatch:
            pts = _f32_rows(batch)                       # [n, dim]
            table = kmeans_partials(pts, c, mask)        # [k, dim+1]
            return _f32_record(table.reshape(1, -1))

        def fold_masked(batch: RecordBatch, mask, _params) -> RecordBatch:
            arr = _f32_rows(batch)                       # [n, k*(dim+1)]
            arr = arr * mask.to(torch.float32)[:, None]
            return _f32_record(arr.sum(0, keepdim=True))

        return [
            SphereStage("assign", masked_udf=assign_masked,
                        partitioner=reduce_partitioner()),
            SphereStage("fold", masked_udf=fold_masked),
        ]

    assign = SphereStage("assign", partitioner=reduce_partitioner())

    def assign_udf(records: List[bytes]) -> List[bytes]:
        c = np.asarray(assign.params)
        out = []
        for blob in records:
            pts = decode_points(blob, dim)
            d2 = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
            a = d2.argmin(1)
            sums = np.zeros((k, dim))
            counts = np.zeros(k, np.int64)
            np.add.at(sums, a, pts)
            np.add.at(counts, a, 1)
            out.append(_encode_partial(sums, counts))
        return out

    def fold_udf(records: List[bytes]) -> List[bytes]:
        sums = np.zeros((k, dim))
        counts = np.zeros(k, np.int64)
        for r in records:
            s, n = _decode_partial(r)
            sums += s
            counts += n
        return [_encode_partial(sums, counts)]

    assign.udf = assign_udf
    return [assign, SphereStage("fold", fold_udf)]


def _fold_outputs(outputs: List[bytes], dim: int, k: int, backend: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(sums, counts) from a job's final blobs (normally one fold record;
    summing tolerates degenerate multi-bucket outputs)."""
    sums = np.zeros((k, dim))
    counts = np.zeros(k, np.float64)
    for blob in outputs:
        if backend == "array":
            arr = np.frombuffer(blob, "<f4").reshape(-1, k, dim + 1)
            sums += arr[..., :dim].sum(0)
            counts += arr[..., dim].sum(0)
        else:
            off = 0
            while off < len(blob):
                kk, dd = struct.unpack("<II", blob[off:off + 8])
                size = 8 + 8 * kk * dd + 8 * kk
                s, n = _decode_partial(blob[off:off + size])
                sums += s
                counts += n
                off += size
    return sums, counts


def _stage_params(centroids: np.ndarray, backend: str, device):
    """The assign stage's params: a float32 tensor on ``device`` (array),
    or a numpy copy (bytes)."""
    if backend == "array":
        return torch.from_numpy(centroids.copy()).to(device)
    return centroids.copy()


# --------------------------- driver ----------------------------------------

def kmeans_sphere(engine: SphereEngine, file: str, dim: int, k: int,
                  iters: int, seed: int = 0, backend: str = "bytes",
                  session: Union[bool, SphereSession, None] = True,
                  iter_seconds: Optional[List[float]] = None,
                  init: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, SphereReport]:
    """Run k-means over a Sector file of float32 points via Sphere.

    ``session=True`` (default) chains the iterations through one
    :class:`SphereSession` — one lookup, one stage-0 plan, chunks decoded
    once, each stage UDF at one block shape for the whole run; pass an
    existing session to share it.  ``session=False`` re-plans every
    iteration through ``engine.run`` (kept as the comparison baseline).
    ``iter_seconds``, when given a list, collects real per-iteration wall
    clock.  ``init`` warm-starts the centroids (overriding the seeded
    random init) — streaming windows warm-start from the previous
    window's model.
    """
    if init is not None:
        centroids = np.array(init, dtype=np.float32, copy=True)
        if centroids.shape != (k, dim):
            raise ValueError(f"init shape {centroids.shape} != {(k, dim)}")
    else:
        rng = np.random.default_rng(seed)
        centroids = rng.normal(size=(k, dim)).astype(np.float32)
    report = SphereReport()
    record_size = 4 * dim if backend == "array" else 0

    sess: Optional[SphereSession] = None
    own_session = False
    if isinstance(session, SphereSession):
        sess = session
    elif session:
        sess = engine.session(file, record_size=record_size, backend=backend)
        own_session = True  # close (unsubscribe) our throwaway session
    if sess is not None:
        stages = make_kmeans_stages(dim, k, backend)
        job = SphereJob("kmeans", file, stages, record_size=record_size,
                        backend=backend)

    try:
        tracer = getattr(engine, "tracer", None) or NULL_TRACER
        for it in range(iters):
            with tracer.span("kmeans-iter", track="control",
                             attrs={"iter": it, "k": k}) as sp:
                if sess is None:
                    # re-plan path: fresh stages, fresh job, fresh
                    # planner/executor on every iteration
                    stages = make_kmeans_stages(dim, k, backend)
                    job = SphereJob("kmeans", file, stages,
                                    record_size=record_size, backend=backend)
                stages[0].params = _stage_params(centroids, backend,
                                                 engine.device)
                if sess is not None:
                    outputs, report = sess.run(job, report)
                else:
                    outputs, report = engine.run(job, report)
                sums, counts = _fold_outputs(outputs, dim, k, backend)
                nz = counts > 0
                centroids[nz] = (sums[nz]
                                 / counts[nz, None]).astype(np.float32)
            if iter_seconds is not None:
                iter_seconds.append(sp.wall_seconds)
    finally:
        if own_session:
            sess.close()
    return centroids, report


# --------------------------- streaming driver -------------------------------

class StreamingKMeans:
    """Warm-started k-means over a :class:`SphereStream`'s window sequence
    (the continuous Angle workload: cluster every window of TCP-flow
    feature files as it forms).

    One stage pair and one :class:`SphereJob` serve every window: the
    centroids ride in ``stages[0].params`` (a tensor on the stream's
    engine device), so the whole stream runs each stage at one block
    shape (``report.udf_traces == 1``) no matter how many windows or
    iterations run.  Each window warm-starts from the previous window's
    centroids; the model sequence itself is the temporal signal Angle's
    anomaly detector consumes.

    Typical wiring (fit runs synchronously as each window forms)::

        stream = engine.stream("angle/window_", window=WindowPolicy.sliding(4),
                               record_size=4 * dim, backend="array")
        skm = StreamingKMeans(stream, dim, k, iters=4)
        stream.on_window(lambda s, i, files: models.append(skm.fit_window()))
    """

    def __init__(self, stream, dim: int, k: int, *, iters: int = 4,
                 seed: int = 0):
        self.stream = stream
        self.dim = dim
        self.k = k
        self.iters = iters
        self.seed = seed
        self.backend = stream.backend
        self.stages = make_kmeans_stages(dim, k, self.backend)
        self.job = SphereJob("kmeans-stream", stream.job_input_name,
                             self.stages, record_size=stream.record_size,
                             backend=self.backend)
        self.centroids: Optional[np.ndarray] = None
        self.report = SphereReport()
        self.windows_fit = 0

    def fit_window(self, iters: Optional[int] = None) -> np.ndarray:
        """Fit the stream's *current* window, warm-starting from the
        previous window's centroids (cold seeded init on the first call).
        Returns a copy of the fitted centroids; cumulative counters
        accrue in ``self.report``."""
        if self.centroids is None:
            rng = np.random.default_rng(self.seed)
            self.centroids = rng.normal(size=(self.k, self.dim)) \
                .astype(np.float32)
        for _ in range(self.iters if iters is None else iters):
            self.stages[0].params = _stage_params(
                self.centroids, self.backend, self.stream.engine.device)
            outs, self.report = self.stream.run(self.job, self.report)
            sums, counts = _fold_outputs(outs, self.dim, self.k,
                                         self.backend)
            nz = counts > 0
            self.centroids[nz] = (sums[nz] / counts[nz, None]) \
                .astype(np.float32)
        self.windows_fit += 1
        return self.centroids.copy()


# --------------------------- the step ---------------------------------------

def kmeans_step(points: torch.Tensor, centroids: torch.Tensor,
                mesh: Optional[Mesh] = None, axis: str = "data"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One k-means step: points [N, D] (this rank's block when ``mesh`` is
    given), centroids [K, D] replicated.  Returns (new_centroids,
    inertia), replicated; an empty centroid keeps its place.  With a mesh
    the per-centroid sums, counts and inertia are summed over the ranks
    (``kmeans_step_jax``'s ``psum``)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch Mesh, got "
                        f"{type(mesh).__name__}")
    d2 = ((points ** 2).sum(1)[:, None] - 2 * points @ centroids.T
          + (centroids ** 2).sum(1)[None])
    a = d2.argmin(1)
    oh = torch.nn.functional.one_hot(a, centroids.shape[0]).to(points.dtype)
    sums = oh.T @ points
    counts = oh.sum(0)
    inertia = d2.gather(1, a[:, None]).sum()
    if mesh is not None:
        sums, counts = psum(sums, mesh, axis), psum(counts, mesh, axis)
        inertia = psum(inertia.reshape(1), mesh, axis)[0]
    new_c = torch.where(counts[:, None] > 0,
                        sums / counts[:, None].clamp_min(1), centroids)
    return new_c, inertia
