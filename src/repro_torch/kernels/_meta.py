"""What the hand-written kernels' meta routes launched: the card's work
counted without a card.

On a ``meta`` tensor (``launch/dryrun.py`` runs a step on them) a
kernel's entry point takes neither its CUDA launch nor its plain
version: its wrapper checks the inputs as the launch does, makes
outputs of the kernel's shapes and types, adds one to the kernel's own
launch counter, and records here the operations and bytes that the
kernel's closed-form cost function (``<kernel>/cost.py``) gives for
those shapes.  ``TALLY`` maps a kernel's name to ``{"launches", "ops",
"bytes"}``; :func:`reset` empties it.
"""
from __future__ import annotations

TALLY: dict = {}


def record(name: str, ops: int, n_bytes: int) -> None:
    """One launch of kernel ``name`` doing ``ops`` operations over
    ``n_bytes`` bytes."""
    t = TALLY.setdefault(name, {"launches": 0, "ops": 0, "bytes": 0})
    t["launches"] += 1
    t["ops"] += int(ops)
    t["bytes"] += int(n_bytes)


def reset() -> None:
    TALLY.clear()
