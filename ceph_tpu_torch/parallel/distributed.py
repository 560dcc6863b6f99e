"""Multi-host initialization — the cross-host half of the comm backend.

Twin of ceph_tpu/parallel/distributed.py (ref: src/msg/async/
AsyncMessenger.cc — every OSD/mon process dials peers over TCP/RDMA;
SURVEY.md §5). This module owns the process-level wiring.

How JAX's model maps onto torch's: JAX runs one process per host, and
after `jax.distributed.initialize` each process sees the global device
list. Torch runs one rank per card, so

* `init_process(coordinator, num_processes, process_id, local_devices)`
  is `torch.distributed.init_process_group(init_method=
  f"tcp://{coordinator}")`: `num_processes` is the world size in ranks,
  `process_id` the rank, `local_devices` the ranks per host (default
  `LOCAL_WORLD_SIZE` where it is set, else `torch.cuda.device_count()`).
  The rank's host is rank // local_devices, and it binds
  `cuda:(rank % local_devices)`. The backend is NCCL on a card host,
  gloo only with device="cpu".
* `host_mesh()` — a ("dp", "shard") mesh laid out so the shard axis
  stays INSIDE each host's ranks (NVLink) and dp crosses hosts. The
  shard-group collectives (the per-stripe gather, the hot path) never
  leave a host; only the batch axis, which needs no communication
  during encode/decode, spans the slower network.
* `global_batch()` — each rank passes its host's (B_local, k, L) and
  gets its dp block of the global (sum of B_local, k, L) batch,
  dp-major, as `jax.make_array_from_process_local_data` lays it out.
  No collective: a host_mesh rank's block lies in its own host's rows.

Verified by tests/test_torch_distributed.py, which spawns real ranks
(2 "hosts" x 2 gloo ranks on localhost) and runs the sharded encoder and
decoder over the spanning mesh.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, Sharded, data_sharding

# ranks per host, as init_process set it (None: not set here)
_LOCAL_DEVICES: list = [None]


def _local_devices() -> int:
    """Ranks per host: init_process's, else LOCAL_WORLD_SIZE, else the
    cards this process sees."""
    n = _LOCAL_DEVICES[0] or int(os.environ.get("LOCAL_WORLD_SIZE", 0)) \
        or torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("ranks per host unknown: pass local_devices to "
                           "init_process or set LOCAL_WORLD_SIZE")
    return n


def init_process(coordinator: str, num_processes: int,
                 process_id: int, local_devices: int | None = None,
                 device=None) -> torch.device:
    """Join the process group (call once per rank, before any mesh):
    `coordinator` is "host:port" of rank 0's rendezvous. Binds
    cuda:(rank % local_devices) over NCCL, or the CPU over gloo when
    device="cpu". Returns the rank's device."""
    if local_devices is not None:
        _LOCAL_DEVICES[0] = int(local_devices)
    n_local = _local_devices()
    if device is not None and torch.device(device).type == "cpu":
        dev, kw = torch.device("cpu"), {"backend": "gloo"}
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the ranks over gloo on the CPU")
        dev = torch.device("cuda", process_id % n_local)
        torch.cuda.set_device(dev)
        kw = {"backend": "nccl", "device_id": dev}
    dist.init_process_group(init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    return dev


def host_mesh(shard: int | None = None, device=None) -> Mesh:
    """Global ("dp", "shard") mesh with shard-axis locality: the ranks of
    a row belong to one host, so per-stripe collectives stay on it; rows
    (dp) cross hosts."""
    n_local = _local_devices()
    world = dist.get_world_size()
    procs: dict[int, list] = {}
    for r in range(world):
        procs.setdefault(r // n_local, []).append(r)
    per_host = {p: len(rs) for p, rs in procs.items()}
    if len(set(per_host.values())) > 1:
        # uneven hosts would contribute uneven dp-row counts, breaking
        # the equal-local-batch contract of global_batch(); reject
        # loudly instead of silently dropping ranks
        raise ValueError(f"heterogeneous hosts {per_host}; host_mesh "
                         f"needs the same device count per process")
    if shard is None:
        shard = n_local
    if shard < 1 or n_local % shard:
        raise ValueError(f"shard={shard} does not divide the "
                         f"{n_local} local devices per host")
    rows = []
    for p in sorted(procs):
        rs = procs[p]
        for i in range(0, n_local, shard):
            rows.append(rs[i:i + shard])
    return Mesh(np.asarray(rows), device)


def global_batch(mesh: Mesh, local) -> Sharded:
    """Per-host (B_local, k, L) uint8 -> this rank's block of the global
    batch, data-sharded (dp-major) over the mesh; B_global = the sum of
    the hosts' locals. Every rank of a host passes the same array."""
    n_local = _local_devices()
    hosts = sorted({int(r) // n_local for r in mesh.devices.ravel()})
    arr = local if isinstance(local, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(local))
    b_local = arr.shape[0]
    shape = (b_local * len(hosts), *arr.shape[1:])
    sharding = data_sharding(mesh)
    idx = sharding.index(shape)
    first = hosts.index(mesh.rank // n_local) * b_local
    rows = idx[0]
    if rows.start < first or rows.stop > first + b_local:
        raise ValueError(f"rank {mesh.rank}'s dp block, global rows "
                         f"[{rows.start}, {rows.stop}), lies outside its "
                         f"host's rows [{first}, {first + b_local}): lay "
                         f"the mesh out with host_mesh")
    block = arr[rows.start - first:rows.stop - first]
    return Sharded(block.to(mesh.device).contiguous(), shape, idx, sharding)
