"""Ranks for the port's mesh tests: gloo processes on the CPU.

`start_ranks(fn, world)` spawns `world` ranks of `fn(rank, world, port,
out)` (torch.multiprocessing, start method spawn, one thread each), and
`finish` joins them and returns what each rank saved with `save`. The cases' inputs are made
here from numpy seeds, so that the JAX side of a test makes the same
ones. Imports torch, numpy and the port, never jax."""

from __future__ import annotations

import json
import os
import socket
import tempfile

import numpy as np

# the meshes over 4 ranks: (ranks in order, shard); the reversed one
# numbers each process group's ranks against the mesh's column order
MESHES = {"2x2": ((0, 1, 2, 3), 2), "1x4": ((0, 1, 2, 3), 4),
          "2x2-reversed": ((3, 2, 1, 0), 2)}
# the cases of tests/test_parallel.py and __graft_entry__.dryrun_multichip
DECODES = {"rs42_roundtrip": ((0, 3), (1, 2, 4, 5)),
           "rs83_pad_2_10": ((2, 10), (0, 1, 3, 4, 5, 6, 7, 8)),
           "rs83_0_9": ((0, 9), None),
           "rs83_2_5_10": ((2, 5, 10), None),
           "rs83_8_9_10": ((8, 9, 10), None)}
CASES = ("rs42_encode", "rs83_encode", *DECODES, "lrc_repair", "clay_repair")


def rs_data(name: str) -> np.ndarray:
    """The seeded (8, k, 256) data of an RS case (test_parallel's seeds)."""
    seed, k = {"rs42_encode": (0, 4), "rs42_roundtrip": (1, 4),
               "rs83_encode": (2, 8), "rs83_pad_2_10": (2, 8)}.get(name,
                                                                    (5, 8))
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(8, k, 256), dtype=np.uint8)


def survivors(erasures, given, k=8, n=11):
    return given if given is not None else \
        tuple(s for s in range(n) if s not in erasures)[:k]


def codec_objects(coder, seed: int) -> np.ndarray:
    """(8, 4 chunks of 512-byte stripes) seeded objects of a codec case."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(8, coder.get_chunk_size(512) * 4),
                        dtype=np.uint8)


def lrc_helpers(lrc) -> list:
    n = lrc.get_chunk_count()
    return sorted(lrc.minimum_to_decode([0], [i for i in range(n) if i]))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def save(out: str, rank: int, arrays: dict, meta: dict) -> None:
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def load(out: str, world: int) -> list:
    ranks = []
    for r in range(world):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            arrays = dict(z)
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append((arrays, json.load(f)))
    return ranks


def start_ranks(fn, world: int):
    """Start `world` gloo ranks of `fn`; returns (context, output dir):
    `finish` joins them and loads what they saved."""
    import torch.multiprocessing as mp
    out = tempfile.mkdtemp(prefix="mesh_ranks_")
    ctx = mp.start_processes(fn, args=(world, free_port(), out),
                             nprocs=world, join=False,
                             start_method="spawn")
    return ctx, out


def finish(ctx, out: str, world: int, timeout: float = 300.0) -> list:
    """Join the ranks (a rank's failure raises here), give up after
    `timeout` seconds, and load what they saved."""
    import shutil
    import time
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in "
                                   f"{timeout:.0f} s")
        return load(out, world)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        shutil.rmtree(out, ignore_errors=True)


def _join(rank: int, world: int, port: int, local: int):
    import torch

    from ceph_tpu_torch.parallel.distributed import init_process
    torch.set_num_threads(1)
    return init_process(f"127.0.0.1:{port}", world, rank,
                        local_devices=local, device="cpu")


def _block(arrays: dict, meta: dict, key: str, sharded, step=None) -> None:
    arrays[key] = sharded.local.numpy()
    meta[key] = {"index": [[s.start, s.stop] for s in sharded.index],
                 "shape": list(sharded.global_shape),
                 "spec": list(sharded.sharding.spec),
                 "wire": None if step is None else vars(step.wire).copy()}


def parallel_rank(rank: int, world: int, port: int, out: str) -> None:
    """Every case of test_torch_parallel.py on every mesh of MESHES."""
    import torch
    import torch.distributed as dist

    from ceph_tpu_torch.ec.linearize import derive_repair_matrix
    from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.parallel import mesh as M

    _join(rank, world, port, world)
    arrays, meta = {}, {"errors": {}}
    for what, call in (("no_device", lambda: M.default_mesh(shard=2)),
                       ("cuda_on_gloo", lambda: M.default_mesh(
                           shard=2, device="cuda")),
                       ("shard_3", lambda: M.default_mesh(shard=3,
                                                          device="cpu")),
                       ("too_many", lambda: M.virtual_mesh(8, 2, "cpu"))):
        try:
            call()
        except (RuntimeError, ValueError) as e:
            meta["errors"][what] = [type(e).__name__, str(e)]
    cpu = torch.device("cpu")
    lrc = factory("plugin=lrc k=4 m=2 l=3", device=cpu)
    clay = factory("plugin=clay k=4 m=2", device=cpu)
    for label, (ranks, shard) in MESHES.items():
        mesh = M.virtual_mesh(world, shard, device="cpu") \
            if ranks == tuple(range(world)) else \
            M.default_mesh(list(ranks), shard, device="cpu")
        meta[f"{label}/mesh"] = {
            "devices": mesh.devices.tolist(), "axes": list(mesh.axis_names),
            "position": list(mesh.position),
            "slots": [M.padded_slots(n, mesh) for n in (6, 11, 12)]}
        encoders = {k: M.make_sharded_encoder(reed_sol_van_matrix(k, m),
                                              mesh)
                    for k, m in ((4, 2), (8, 3))}
        for name in ("rs42_encode", "rs83_encode"):
            step = encoders[4 if name == "rs42_encode" else 8]
            step.wire.reset()
            _block(arrays, meta, f"{label}/{name}", step(rs_data(name)),
                   step)
        chunks = encoders[8](rs_data("rs83_encode"))
        full = chunks.gather_global()
        if rank == 0:
            arrays[f"{label}/gather_global"] = full.numpy()
        for name, (erasures, given) in DECODES.items():
            k = 4 if name.startswith("rs42") else 8
            mat = reed_sol_van_matrix(k, 2 if k == 4 else 3)
            step = M.make_sharded_decoder(
                mat, erasures, survivors(erasures, given, k, k + mat.shape[0]),
                mesh)
            enc = encoders[k](rs_data(name))
            _block(arrays, meta, f"{label}/{name}", step(enc), step)
        objs = codec_objects(lrc, 6)
        lchunks = torch.stack([M.encode_all_chunks(lrc, o) for o in objs])
        n = lrc.get_chunk_count()
        lchunks = torch.nn.functional.pad(
            lchunks, (0, 0, 0, M.padded_slots(n, mesh) - n))
        helpers = lrc_helpers(lrc)
        step = M.make_sharded_gather_apply(
            derive_repair_matrix(lrc, [0], helpers), tuple(helpers), mesh)
        _block(arrays, meta, f"{label}/lrc_repair", step(lchunks), step)
        arrays[f"{label}/lrc_chunks"] = lchunks.numpy()
        objs = codec_objects(clay, 7)
        cchunks = torch.stack([M.encode_all_chunks(clay, o) for o in objs])
        n = clay.get_chunk_count()
        cchunks = torch.nn.functional.pad(
            cchunks, (0, 0, 0, M.padded_slots(n, mesh) - n))
        step = M.make_sharded_clay_repair(
            clay, 1, tuple(i for i in range(n) if i != 1), mesh)
        _block(arrays, meta, f"{label}/clay_repair", step(cchunks), step)
        arrays[f"{label}/clay_chunks"] = cchunks.numpy()
    save(out, rank, arrays, meta)
    dist.destroy_process_group()


def distributed_rank(rank: int, world: int, port: int, out: str) -> None:
    """test_distributed.py's two-host run: 2 hosts x 2 ranks,
    host_mesh(shard=2), per-host data from seeds 7 + host."""
    import torch.distributed as dist

    from ceph_tpu_torch.ec.matrices import reed_sol_van_matrix
    from ceph_tpu_torch.parallel import distributed as D
    from ceph_tpu_torch.parallel import mesh as M

    device = _join(rank, world, port, 2)
    arrays, meta = {}, {"device": str(device), "errors": {}}
    mesh = D.host_mesh(shard=2, device="cpu")
    meta["devices"] = mesh.devices.tolist()
    host = rank // 2
    K, Mp, L = 4, 2, 4096
    matrix = reed_sol_van_matrix(K, Mp)
    local = np.random.default_rng(7 + host).integers(0, 256, (8, K, L),
                                                     dtype=np.uint8)
    gdata = D.global_batch(mesh, local)
    _block(arrays, meta, "data", gdata)
    enc = M.make_sharded_encoder(matrix, mesh)
    chunks = enc(gdata)
    _block(arrays, meta, "chunks", chunks, enc)
    dec = M.make_sharded_decoder(matrix, (0, 5), (1, 2, 3, 4), mesh)
    _block(arrays, meta, "rebuilt", dec(chunks), dec)
    wide = M.default_mesh(shard=4, device="cpu")
    for what, call in (("shard_3", lambda: D.host_mesh(shard=3)),
                       ("cross_host", lambda: D.global_batch(wide, local))):
        try:
            call()
        except ValueError as e:
            meta["errors"][what] = str(e)
    D._LOCAL_DEVICES[0] = 3                  # 3 + 1 ranks: uneven hosts
    try:
        D.host_mesh()
    except ValueError as e:
        meta["errors"]["heterogeneous"] = str(e)
    D._LOCAL_DEVICES[0] = 2
    save(out, rank, arrays, meta)
    dist.destroy_process_group()
