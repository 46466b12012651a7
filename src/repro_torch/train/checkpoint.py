"""Checkpoints stored *through Sector*: replicated, content-hashed, atomic.

The port of ``repro.train.checkpoint``, in the same format, so a
checkpoint written by either package restores in the other.

Layout per step:
    ckpt/<tag>/step_<N>.bin            -- packed leaf payload (zlib)
    ckpt/<tag>/step_<N>.manifest.json  -- written LAST = atomic commit point

The manifest carries per-leaf (path, shape, dtype, offset, nbytes) plus a
sha256 of the payload; restore picks the newest step whose manifest exists
AND whose payload hash verifies, so a failure mid-upload can never yield a
half-written restore point. Replication (>=2 sites) comes for free from the
Sector placement policy.

bf16 leaves are serialised as exact float32 (bf16<->f32 round-trips
losslessly); everything else is stored raw.  Dtype names are numpy's
("float32", "int32", "bfloat16"), as the JAX package writes them.
"""
from __future__ import annotations

import hashlib
import io
import json
import re
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import to_dtype
from repro_torch.sector.client import SectorClient
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_unflatten


def _to_numpy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.float().cpu().numpy(), "bfloat16"
    return x.cpu().numpy(), str(x.dtype).removeprefix("torch.")


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    return torch.from_numpy(arr.copy()).to(device=device,
                                           dtype=to_dtype(dtype))


def serialize(tree) -> Tuple[bytes, dict]:
    flat = tree_flatten_with_paths(tree)
    buf = io.BytesIO()
    leaves = []
    for path, leaf in flat:
        arr, dtype = _to_numpy(leaf)
        off = buf.tell()
        buf.write(np.ascontiguousarray(arr).tobytes())
        leaves.append({"path": path, "shape": list(arr.shape),
                       "store_dtype": str(arr.dtype), "dtype": dtype,
                       "offset": off, "nbytes": buf.tell() - off})
    payload = zlib.compress(buf.getvalue(), level=1)
    manifest = {"leaves": leaves,
                "payload_sha256": hashlib.sha256(payload).hexdigest(),
                "payload_bytes": len(payload)}
    return payload, manifest


def deserialize(payload: bytes, manifest: dict, like_tree) -> Any:
    """The tree of ``like_tree``'s paths from a payload; a leaf lands on
    the device of the tensor in ``like_tree`` at its path, and on the CPU
    where ``like_tree`` holds a TensorSpec."""
    if hashlib.sha256(payload).hexdigest() != manifest["payload_sha256"]:
        raise IOError("checkpoint payload hash mismatch")
    raw = zlib.decompress(payload)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    leaves = []
    for path, like in tree_flatten_with_paths(like_tree):
        meta = by_path[path]
        arr = np.frombuffer(
            raw, meta["store_dtype"],
            count=int(np.prod(meta["shape"])) if meta["shape"] else 1,
            offset=meta["offset"]).reshape(meta["shape"])
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
        leaves.append(_from_numpy(arr, meta["dtype"], device))
    return tree_unflatten(like_tree, leaves)


class SectorCheckpointer:
    def __init__(self, client: SectorClient, tag: str,
                 replication: int = 2, keep: int = 3):
        self.client = client
        self.tag = tag
        self.replication = replication
        self.keep = keep

    def _bin(self, step: int) -> str:
        return f"ckpt/{self.tag}/step_{step:08d}.bin"

    def _man(self, step: int) -> str:
        return f"ckpt/{self.tag}/step_{step:08d}.manifest.json"

    def save(self, step: int, state: dict) -> None:
        """state: {'params':..., 'opt':..., 'extra': dict}."""
        payload, manifest = serialize(
            {"params": state["params"], "opt": state["opt"]})
        manifest["extra"] = state.get("extra", {})
        manifest["step"] = step
        self.client.upload(self._bin(step), payload,
                           replication=self.replication)
        self.client.upload(
            self._man(step), json.dumps(manifest).encode(),
            replication=self.replication)   # manifest last = commit
        self._gc()

    def steps(self) -> list:
        pat = re.compile(
            rf"ckpt/{re.escape(self.tag)}/step_(\d+)\.manifest\.json$")
        out = []
        for name in self.client.master.files:
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore_latest(self, like: dict) -> Optional[dict]:
        """like: {'params': specs-or-tensors, 'opt': ...}. Tries newest
        first; skips corrupt/incomplete checkpoints."""
        for step in reversed(self.steps()):
            try:
                manifest = json.loads(
                    self.client.download(self._man(step)).decode())
                payload = self.client.download(self._bin(step))
                tree = deserialize(payload, manifest,
                                   {"params": like["params"],
                                    "opt": like["opt"]})
                return {"step": step, "params": tree["params"],
                        "opt": tree["opt"],
                        "extra": manifest.get("extra", {})}
            except (IOError, KeyError, FileNotFoundError):
                continue
        return None

    def _gc(self) -> None:
        steps = self.steps()
        for step in steps[:-self.keep]:
            for name in (self._bin(step), self._man(step)):
                fm = self.client.master.files.pop(name, None)
                if fm is None:
                    continue
                for cid in fm.chunk_ids:
                    ck = self.client.master.chunks.pop(cid, None)
                    if ck is None:
                        continue
                    for sid in ck.locations:
                        srv = self.client.master.servers.get(sid)
                        if srv is not None and srv.alive:
                            srv.delete_chunk(cid)
