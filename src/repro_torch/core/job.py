"""Sphere job model: arbitrary UDF stages over a stream of records.

The paper's programming model (§4): the dataset is a stream divided into
chunks already distributed by Sector; ``sphere.run(data, process)`` applies
``process`` to every record in parallel where the data lives; between stages
data is shuffled as required. Unlike MapReduce, *both* positions are
arbitrary UDFs — a stage is any record->records function, optionally
followed by a partitioner that reshuffles records across buckets.

Two record backends:

* ``backend="bytes"`` (reference): records are Python ``bytes``; a stage's
  ``udf`` maps a list of records to a list of records and the shuffle
  calls the partitioner once per record.
* ``backend="array"``: records are packed into :class:`RecordBatch`
  arrays; a stage's ``batch_udf`` is a (typically jitted) ``RecordBatch ->
  RecordBatch`` function and the shuffle runs the Pallas bucket-partition
  kernel + one argsort/gather per worker batch.  Requires a fixed
  ``record_size``.  A stage with only a bytes ``udf`` still works on the
  array backend through a decode/re-encode compatibility path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core.records import RecordBatch

# A UDF maps a list of records (bytes each) to a list of records.
UDF = Callable[[Sequence[bytes]], List[bytes]]
# A batch UDF maps a RecordBatch to a RecordBatch (array backend).
BatchUDF = Callable[[RecordBatch], RecordBatch]
# A mask-aware UDF maps (padded RecordBatch, validity mask, params) to a
# RecordBatch whose row count depends only on the padded input shape —
# the contract for reduction-shaped stages (array backend).
MaskedUDF = Callable[[RecordBatch, Any, Any], RecordBatch]
# A partitioner maps one record to a bucket index in [0, n_buckets).
Partitioner = Callable[[bytes, int], int]

BACKENDS = ("bytes", "array")


@dataclass
class SphereStage:
    name: str
    udf: Optional[UDF] = None
    partitioner: Optional[Partitioner] = None  # None = no shuffle after
    n_buckets: int = 0                         # 0 = same as worker count
    batch_udf: Optional[BatchUDF] = None       # array-backend stage body
    # pad_value declares batch_udf *pad-stable*: the array executor may
    # pad input rows with this byte up to a fixed block shape, call
    # the UDF on the padded batch (so it is traced once per stage, not
    # once per task shape), and slice the first n rows back off.  The
    # UDF must preserve the row count and keep padding rows at the tail
    # — e.g. identity, row-local maps, or a stable sort with max-byte
    # (0xff) padding.  None = shape-polymorphic UDF, traced per shape.
    pad_value: Optional[int] = None
    # masked_udf declares the stage *mask-aware* (reduction-shaped): the
    # array executor pads the input batch with pad_value (default 0) to
    # the stage's fixed block shape and calls
    # ``masked_udf(batch, mask, params)`` where ``mask`` is a bool [rows]
    # validity vector (True = real record).  Unlike pad-stable batch
    # UDFs, the output row count may differ from the input — it must
    # depend only on the padded shape (e.g. a k-means assign stage that
    # folds any number of points into one partial record), and every
    # output row is real (no un-pad slice).  The executor jits the call
    # once per stage with (data, n_valid, params) as dynamic arguments,
    # so a chain of jobs re-running the stage with new ``params`` values
    # never retraces.  masked_udf and batch_udf are mutually exclusive.
    masked_udf: Optional[MaskedUDF] = None
    # per-run parameters, passed to masked_udf as a dynamic jit argument
    # (a pytree of arrays).  Mutate between session runs — e.g. the
    # current k-means centroids — without invalidating the traced UDF.
    # Bytes UDFs may read it via a closure over the stage object.
    params: Any = None

    def __post_init__(self):
        if self.masked_udf is not None and self.batch_udf is not None:
            raise ValueError(f"stage {self.name!r} declares both batch_udf "
                             f"and masked_udf; they are mutually exclusive")
        if self.masked_udf is not None and self.pad_value is None:
            self.pad_value = 0  # masked stages neutralise padding via mask

    def apply_bytes(self, records: Sequence[bytes]) -> List[bytes]:
        if self.udf is None:
            raise ValueError(f"stage {self.name!r} has no bytes udf "
                             f"(backend='bytes' needs one)")
        return self.udf(records)

    def apply_batch(self, batch: RecordBatch) -> RecordBatch:
        if self.batch_udf is not None:
            out = self.batch_udf(batch)
            if not isinstance(out, RecordBatch):
                raise TypeError(f"stage {self.name!r} batch_udf must return "
                                f"a RecordBatch, got {type(out).__name__}")
            return out
        # compatibility: run the bytes udf over the unpacked batch
        out_records = self.apply_bytes(batch.to_records())
        if not out_records:
            return RecordBatch.empty(batch.record_size)
        return RecordBatch.from_records(out_records)


@dataclass
class SphereJob:
    name: str
    input_file: str
    stages: List[SphereStage]
    record_size: int = 0   # fixed-size records; 0 = whole chunk is 1 record
    backend: str = "bytes"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"choose from {BACKENDS}")
        if self.backend == "array" and self.record_size <= 0:
            raise ValueError("backend='array' requires a fixed "
                             "record_size > 0")

    def split_records(self, blob: bytes) -> List[bytes]:
        if not self.record_size:
            return [blob]
        rs = self.record_size
        return [blob[i:i + rs] for i in range(0, len(blob) - rs + 1, rs)]

    def split_batch(self, blob: bytes) -> RecordBatch:
        return RecordBatch.from_bytes(blob, self.record_size)
