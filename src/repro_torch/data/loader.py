"""Sharded, deterministic host data loading; port of `repro.data.loader`.

Multi-host contract: each host materializes only its slice of the global
batch (`host_slice`), and the slice is a pure function of (seed, step,
host_id, num_hosts). Elastic rescaling re-derives slices from the same
stream, so no data is skipped or duplicated after a restart with a
different host count.

Where the JAX version reads `jax.process_index()` / `process_count()`,
this one reads the rank and world size of `torch.distributed` when it is
initialised (else 0 and 1); where it places the batch against a sharding
tree, this one moves it to an explicit `device`.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import Device, resolve_device


def _process() -> tuple:
    """(rank, world size) of this process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(global_batch: int, host_id: Optional[int] = None,
               num_hosts: Optional[int] = None) -> slice:
    rank, world = _process()
    host_id = rank if host_id is None else host_id
    num_hosts = world if num_hosts is None else num_hosts
    per_host = global_batch // num_hosts
    assert per_host * num_hosts == global_batch, \
        f"global_batch {global_batch} not divisible by {num_hosts} hosts"
    return slice(host_id * per_host, (host_id + 1) * per_host)


class BatchLoader:
    """Wraps a (step -> global batch dict) function with host slicing and,
    given a `device`, moves the slice there as tensors (numpy arrays
    otherwise)."""

    def __init__(self, batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 device: Optional[Device] = None,
                 host_id: Optional[int] = None,
                 num_hosts: Optional[int] = None):
        self.batch_fn = batch_fn
        self.device = None if device is None else resolve_device(device)
        self.host_id = host_id
        self.num_hosts = num_hosts

    def __call__(self, step: int) -> Dict:
        global_batch = self.batch_fn(step)
        sl = None
        out = {}
        for k, v in global_batch.items():
            if sl is None:
                sl = host_slice(v.shape[0], self.host_id, self.num_hosts)
            out[k] = v[sl]
        if self.device is not None:
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in out.items()}
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self(step)
            step += 1
