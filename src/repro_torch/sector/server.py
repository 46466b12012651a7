"""Chunk server: stores chunk bytes as real files under a local directory."""
from __future__ import annotations

import os
from pathlib import Path

from repro_torch.sector.chunk import checksum


class ServerDown(ConnectionError):
    pass


class ChunkServer:
    def __init__(self, server_id: str, site: str, root: str | Path):
        self.server_id = server_id
        self.site = site
        self.root = Path(root) / server_id
        self.root.mkdir(parents=True, exist_ok=True)
        self.alive = True

    # -- fault injection ----------------------------------------------------
    def kill(self) -> None:
        self.alive = False

    def revive(self) -> None:
        self.alive = True

    def _check(self) -> None:
        if not self.alive:
            raise ServerDown(self.server_id)

    def _path(self, chunk_id: str) -> Path:
        return self.root / chunk_id.replace("/", "_").replace("#", "__")

    # -- chunk ops ----------------------------------------------------------
    def write_chunk(self, chunk_id: str, data: bytes) -> str:
        self._check()
        p = self._path(chunk_id)
        tmp = p.with_suffix(".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, p)  # atomic publish
        return checksum(data)

    def read_chunk(self, chunk_id: str) -> bytes:
        self._check()
        p = self._path(chunk_id)
        if not p.exists():
            raise FileNotFoundError(chunk_id)
        return p.read_bytes()

    def has_chunk(self, chunk_id: str) -> bool:
        return self.alive and self._path(chunk_id).exists()

    def delete_chunk(self, chunk_id: str) -> None:
        self._check()
        p = self._path(chunk_id)
        if p.exists():
            p.unlink()

    def verify_chunk(self, chunk_id: str, digest: str) -> bool:
        try:
            return checksum(self.read_chunk(chunk_id)) == digest
        except (ServerDown, FileNotFoundError):
            return False

    def used_bytes(self) -> int:
        return sum(f.stat().st_size for f in self.root.iterdir()
                   if f.is_file())
