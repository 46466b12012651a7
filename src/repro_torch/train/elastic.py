"""Elastic scaling: survive device/host loss by remeshing + restoring.

The port of ``repro.train.elastic`` on ``torch.distributed``.  The
1000+-node posture: when a host dies mid-run,
  1. the failure is detected (heartbeat timeout on the Sector side; a
     raised error on the training side),
  2. the controller rebuilds a mesh without the lost host's ranks — the
     mesh shrinks along the ``data`` (or ``pod``) axis, never ``model``
     (TP degree is a property of the checkpointed layout),
  3. the latest committed Sector checkpoint (params + optimizer + data
     cursor) is restored onto the new mesh — placement is re-derived from
     the PartitionSpecs, which are mesh-shape-agnostic,
  4. training resumes; the consistent-hash ring keeps chunk reassignment to
     ~1/n.

Here the "failure" is injected (``HostFailure`` at a chosen step) and
the lost host's ranks are the last ones: ``make_mesh(n)`` builds a mesh
over the first ``n`` ranks of the default group.  Building a process
group is collective, so every rank of the default group takes part in
every remesh, a rank left out too: it follows the same failure schedule
without training (every rank runs the same program and knows it), then
waits at a barrier on the default group until the survivors finish.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch.distributed as dist

from repro_torch.train.trainer import Trainer


class HostFailure(RuntimeError):
    pass


def _world() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


@dataclass
class ElasticController:
    trainer: Trainer
    make_mesh: Callable[[int], object]  # n ranks -> Mesh, None if left out
    max_restarts: int = 3

    def run_with_failures(self, steps: int,
                          fail_at: Optional[List[int]] = None) -> dict:
        """Run ``steps`` steps; inject HostFailure at the given step indices
        (simulating a lost host), remesh with one fewer rank, and resume
        from the last committed checkpoint.  On a rank left out of the
        mesh, returns with ``left_out`` set once the survivors finish."""
        fail_at = sorted(fail_at or [])
        restarts = 0
        lost_groups = 0
        done = self.trainer.step_idx
        target = done + steps
        while done < target:
            next_fail = fail_at[0] if fail_at else None
            try:
                run_until = min(target,
                                next_fail if next_fail is not None
                                else target)
                n = run_until - done
                if n > 0:
                    self.trainer.run(n)
                done = self.trainer.step_idx
                if next_fail is not None and done >= next_fail:
                    fail_at.pop(0)
                    raise HostFailure(f"injected at step {done}")
            except HostFailure:
                restarts += 1
                lost_groups += 1
                if restarts > self.max_restarts:
                    raise
                # --- remesh: drop one rank, rebuild, restore ---
                new_mesh = self.make_mesh(max(1, _world() - lost_groups))
                if new_mesh is None:
                    return self._left_out(restarts, lost_groups, fail_at,
                                          target)
                self.trainer.pcfg = self.trainer.pcfg.with_(mesh=new_mesh)
                self.trainer._build()  # restore from checkpoint
                done = self.trainer.step_idx
        if lost_groups and _world() > 1:
            dist.barrier()                 # release the ranks left out
        return {"restarts": restarts, "final_step": done,
                "history": self.trainer.history}

    def _left_out(self, restarts: int, lost_groups: int, fail_at: list,
                  target: int) -> dict:
        """A rank outside the new mesh: free its state, take part in the
        remesh of every failure the survivors will meet (each step in
        ``fail_at`` up to ``target`` is met once, in order), give up
        where they give up, then wait for them at a barrier."""
        self.trainer.params = self.trainer.opt = None
        for _ in [f for f in fail_at if f <= target]:
            restarts += 1
            lost_groups += 1
            if restarts > self.max_restarts:
                raise HostFailure("the survivors gave up")
            self.make_mesh(max(1, _world() - lost_groups))
        dist.barrier()
        return {"restarts": restarts, "final_step": None,
                "history": self.trainer.history, "left_out": True}
