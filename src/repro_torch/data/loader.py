"""Sharded, resumable host loader (the port of ``repro.data.loader``).

Every host computes its own slice of each global batch deterministically
from (seed, step, host assignment); the assignment can be re-balanced by
the straggler watchdog (``distributed.fault.rebalance_assignment``)
without any coordination beyond agreeing on the slow-host map. Batches are
numpy; the trainer moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.distributed.fault import rebalance_assignment


@dataclass
class ShardedLoader:
    source: object                 # MarkovLM / ProfileClassification
    global_batch: int
    seq_len: int
    host_id: int = 0
    num_hosts: int = 1
    step: int = 0
    speed_map: Dict[int, float] = field(default_factory=dict)

    def _host_range(self) -> range:
        return rebalance_assignment(
            self.global_batch, list(range(self.num_hosts)),
            self.speed_map)[self.host_id]

    def next(self) -> dict:
        batch = self.source.sample(self.step, self.global_batch, self.seq_len)
        r = self._host_range()
        out = {k: v[r.start:r.stop] if v.shape and v.shape[0] ==
               self.global_batch else v for k, v in batch.items()}
        self.step += 1
        return out

    # -- checkpointable position ------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict):
        self.step = int(s["step"])
