"""Chunk and file metadata."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Set


CHUNK_SIZE = 64 * 1024 * 1024  # 64 MB default (GFS-style)


def checksum(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


@dataclass
class ChunkMeta:
    chunk_id: str             # "<file>#<index>"
    file: str
    index: int
    size: int
    digest: str
    version: int = 0
    locations: Set[str] = field(default_factory=set)  # server ids

    @staticmethod
    def make_id(file: str, index: int) -> str:
        return f"{file}#{index}"


@dataclass
class FileMeta:
    name: str
    size: int
    n_chunks: int
    owner: str
    replication: int
    chunk_ids: List[str] = field(default_factory=list)
