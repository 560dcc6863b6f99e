"""Multi-GPU sharding: the (dp, shard) mesh over torch.distributed.

Twin of ceph_tpu/parallel/mesh.py, the rebuild's distributed
communication backend (ref: src/msg/async/, ECBackend's sub-op
scatter/gather — SURVEY.md §2.5, §5):

  axis "dp"    — data parallelism over the object batch (many PGs in
                 flight);
  axis "shard" — shard placement: the k+m chunk slots of each stripe
                 live on different ranks, like chunks on different OSDs.

How JAX's model maps onto torch's:

- JAX runs one process per host that sees many devices; a `Mesh` is a
  grid of devices, and `jax.jit(in_shardings=..., out_shardings=...)`
  lets XLA insert the scatter and the all-gather. Torch runs one rank
  (a process) per card; here a `Mesh` is a grid of ranks, and each rank
  holds one block of every sharded array (`Sharded`, the stand-in for a
  `jax.Array`: its `local` tensor, `global_shape` and `index`, the
  slices of `addressable_shards[i].index`).
- The shardings become layout descriptors (`NamedSharding`): which
  global slice the rank at a mesh position holds under
  ("dp", "shard", None) or ("dp", None, None).
- The collectives XLA inserted are written out: the steps all-gather
  over the process group of the rank's shard row, through
  `Mesh.all_gather`, the one wrapper every collective goes through. It
  counts the bytes a rank sends and receives (`Wire`, plain integers).
- NCCL carries CUDA tensors (the default: `cuda:<local rank>`); gloo
  carries CPU tensors, only when the caller passes device="cpu". A mesh
  whose device and backend disagree raises; nothing falls back.

What each step moves (every rank ends up with exactly the block the
twin's output sharding gives the device at its mesh position):

- encode: the input is data-sharded, so each shard row already holds
  its dp slice whole. A rank computes only its own slots: data slots
  are copied, its parity slots come from one gf_apply launch of the
  parity matrix's rows for them, pad slots are zero. No collective.
- gather-apply and decode: each rank contributes the wanted slots it
  holds; the shard row all-gathers exactly those (uneven counts padded
  to the largest and cut off on arrival), and every rank of the row
  runs one gf_apply of D: the output is replicated over "shard".
- Clay repair: each rank first cuts the beta repair-plane sub-chunks
  out of its helper slots, then gathers, so the wire carries
  d * beta * (L / nsub) bytes an object, not d * L (the twin gathers
  whole helper rows and slices the planes afterwards; the rebuilt bytes
  are the same).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..gf.numpy_ref import decode_matrix
from ..ops.rs_kernels import DEFAULT_IMPL, apply_matrix


@dataclasses.dataclass
class Wire:
    """Bytes a rank moved through `Mesh.all_gather`: `sent` (its block,
    padding included, once to each peer), `received` (the peers'
    blocks, padding included), `padding` (the part of `received` that
    was padding, cut off on arrival) and the collective `calls`."""
    calls: int = 0
    sent: int = 0
    received: int = 0
    padding: int = 0

    def reset(self) -> None:
        self.calls = self.sent = self.received = self.padding = 0


class Mesh:
    """A (dp, shard) grid of ranks of the running process group.

    `devices` holds the ranks in the twin's shape. Construction is
    collective: every rank of the world builds every process group (the
    whole mesh, each shard row, each dp column) in the same order, so
    every rank constructs every mesh, also one it is not part of
    (`position` is then None). `device` is where the rank's blocks live:
    None means the current CUDA device over NCCL; "cpu" needs gloo."""

    axis_names = ("dp", "shard")

    def __init__(self, devices, device=None):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call parallel.distributed"
                               ".init_process (or torch.distributed."
                               "init_process_group) first")
        devices = np.asarray(devices, dtype=np.int64)
        world = dist.get_world_size()
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, shard) grid of "
                             f"ranks, got shape {devices.shape}")
        if len(set(devices.ravel().tolist())) != devices.size or \
                devices.min() < 0 or devices.max() >= world:
            raise ValueError(f"mesh ranks must be distinct ranks of the "
                             f"world of {world}, got {devices.tolist()}")
        self.devices = devices
        self.device = _mesh_device(device)
        self.rank = dist.get_rank()
        here = np.argwhere(devices == self.rank)
        self.position = tuple(int(i) for i in here[0]) if len(here) else None
        # every rank creates every group, in one order
        self._whole = self._group(devices.ravel())
        self._groups = {"shard": [self._group(r) for r in devices],
                        "dp": [self._group(c) for c in devices.T]}
        self.wire = Wire()       # collectives outside the steps

    @staticmethod
    def _group(ranks: np.ndarray):
        """(process group, the place in it of each of `ranks` in order):
        a group numbers its ranks ascending."""
        ranks = [int(r) for r in ranks]
        order = sorted(ranks)
        return dist.new_group(order), [order.index(r) for r in ranks]

    def axis_size(self, axis: str) -> int:
        return self.devices.shape[self.axis_names.index(axis)]

    def position_of(self, rank: int | None = None) -> tuple[int, int]:
        """(dp row, shard column) of `rank` (default: this rank)."""
        rank = self.rank if rank is None else rank
        here = np.argwhere(self.devices == rank)
        if not len(here):
            raise ValueError(f"rank {rank} is not in the mesh "
                             f"{self.devices.tolist()}")
        return int(here[0][0]), int(here[0][1])

    def all_gather(self, tensor: torch.Tensor, axis: str | None,
                   wire: Wire, counts: list[int] | None = None
                   ) -> list[torch.Tensor]:
        """All-gather `tensor` over this rank's group along `axis`
        ("shard": its shard row, "dp": its dp column, None: the whole
        mesh) and return the blocks in the axis's order (the row's
        columns, the column's rows, the mesh's ranks row by row).

        `counts` gives each member's size along dim 1 where they differ:
        every block is padded with zeros to the largest, and each
        arrival is cut to its count. Adds the bytes this rank sent and
        received to `wire`. The one wrapper every collective of the mesh
        goes through."""
        if self.position is None:
            raise ValueError(f"rank {self.rank} is not in the mesh")
        row, col = self.position
        group, place = (self._whole if axis is None else
                        self._groups[axis][row if axis == "shard" else col])
        size = len(place)
        if counts is None:
            counts = [int(tensor.shape[1])] * size
        top = max(counts)
        block = tensor
        if tensor.shape[1] < top:
            block = tensor.new_zeros((tensor.shape[0], top,
                                      *tensor.shape[2:]))
            block[:, :tensor.shape[1]] = tensor
        block = block.contiguous()
        out = block.new_empty((size * block.shape[0], *block.shape[1:]))
        dist.all_gather_into_tensor(out, block, group=group)
        got = out.view(size, *block.shape)
        nbytes = block.numel() * block.element_size()
        me = self._index_in(axis)
        wire.calls += 1
        wire.sent += (size - 1) * nbytes
        wire.received += (size - 1) * nbytes
        wire.padding += sum(top - c for i, c in enumerate(counts)
                            if i != me) * (nbytes // max(top, 1))
        return [got[place[i]][:, :counts[i]] for i in range(size)]

    def _index_in(self, axis: str | None) -> int:
        """This rank's place along `axis` in all_gather's order."""
        row, col = self.position
        if axis == "shard":
            return col
        if axis == "dp":
            return row
        return row * self.devices.shape[1] + col


def _mesh_device(device) -> torch.device:
    """The device of a mesh's blocks, checked against the backend: CUDA
    tensors need NCCL and CPU tensors gloo; anything else raises."""
    backend = str(dist.get_backend())
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(over a gloo process group) to run the "
                               "mesh on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if "nccl" not in backend:
            raise RuntimeError(f"the mesh's CUDA tensors need the NCCL "
                               f"backend, and the process group runs "
                               f"{backend!r}; there is no gloo fallback")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"the mesh's CPU tensors need the gloo "
                               f"backend, and the process group runs "
                               f"{backend!r}")
    else:
        raise ValueError(f"a mesh runs on cuda or cpu, got {device}")
    return device


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout over a mesh: `spec` names, for each dimension, the mesh
    axis it is split over ("dp", "shard") or None (whole on every rank),
    as the twin's `NamedSharding(mesh, PartitionSpec(*spec))`."""
    mesh: Mesh
    spec: tuple

    def index(self, shape: tuple, rank: int | None = None) -> tuple:
        """The global slices the rank holds of an array of `shape`, as
        `addressable_shards[i].index` gives them: slice(start, stop) on
        a split dimension, slice(None) on a whole one. A dimension that
        its axis does not divide raises, as the twin's jit does."""
        pos = dict(zip(Mesh.axis_names, self.mesh.position_of(rank)))
        out = []
        for d, size in enumerate(shape):
            axis = self.spec[d] if d < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            n = self.mesh.axis_size(axis)
            if size % n:
                raise ValueError(f"dimension {d} of size {size} does not "
                                 f"divide evenly over the {n} ranks of "
                                 f"mesh axis {axis!r}")
            part = size // n
            out.append(slice(pos[axis] * part, (pos[axis] + 1) * part))
        return tuple(out)

    def put(self, x) -> Sharded:
        """`x` in this layout, as `jax.device_put(x, sharding)` gives it:
        a `Sharded` in this layout as it is, or the global array (a
        tensor or an array-like, the same on every rank) cut to this
        rank's block on the mesh's device."""
        if isinstance(x, Sharded):
            if x.sharding.mesh is not self.mesh or \
                    x.sharding.spec != self.spec:
                raise ValueError(f"input sharded as {x.sharding.spec} "
                                 f"over another mesh or layout; the step "
                                 f"takes {self.spec} over its own mesh")
            return x
        arr = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        if arr.dtype != torch.uint8:
            raise ValueError(f"sharded steps take uint8, got {arr.dtype}")
        shape = tuple(arr.shape)
        idx = self.index(shape)
        return Sharded(arr[idx].to(self.mesh.device).contiguous(), shape,
                       idx, self)


@dataclasses.dataclass
class Sharded:
    """The port's stand-in for a `jax.Array` spread over a mesh: this
    rank's `local` block of the `global_shape` array, at `index` (the
    global slices it covers) in `sharding`'s layout."""
    local: torch.Tensor
    global_shape: tuple
    index: tuple
    sharding: NamedSharding

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def gather_global(self, dst: int | None = None
                      ) -> torch.Tensor | None:
        """The whole array, assembled from every rank's block (the
        counterpart of `jax.device_get`): on every rank, or on rank
        `dst` only (None elsewhere). Collective over the mesh. Blocks
        that the layout replicates must agree bit for bit, or it
        raises."""
        mesh = self.mesh
        blocks = mesh.all_gather(self.local, None, mesh.wire)
        if dst is not None and mesh.rank != dst:
            return None
        out = torch.empty(self.global_shape, dtype=self.local.dtype,
                          device=self.local.device)
        seen: dict = {}
        for rank, block in zip(mesh.devices.ravel().tolist(), blocks):
            idx = self.sharding.index(self.global_shape, rank)
            key = tuple((s.start, s.stop) for s in idx)
            if key in seen:
                if not torch.equal(seen[key], block):
                    raise RuntimeError(f"ranks hold replicas of block "
                                       f"{key} that disagree")
                continue
            seen[key] = block
            out[idx] = block
        return out


class Step:
    """A sharded step: called with a `Sharded` in its input layout or
    with the global array, it returns this rank's block of the output as
    a `Sharded`. `wire` adds up the bytes its collectives moved on this
    rank over its calls."""

    def __init__(self, mesh: Mesh, in_spec: tuple, out_spec: tuple, body):
        self.mesh = mesh
        self.in_sharding = NamedSharding(mesh, in_spec)
        self.out_sharding = NamedSharding(mesh, out_spec)
        self.body = body
        self.wire = Wire()

    def __call__(self, x) -> Sharded:
        if self.mesh.position is None:
            raise ValueError(f"rank {self.mesh.rank} is not in the mesh")
        x = self.in_sharding.put(x)
        out, out_shape = self.body(self, x.local, x.global_shape)
        return Sharded(out, out_shape, self.out_sharding.index(out_shape),
                       self.out_sharding)

    def slot_range(self, n_slots: int) -> tuple[int, int]:
        """The chunk slots [lo, hi) this rank's shard column holds."""
        s = self.mesh.axis_size("shard")
        col = self.mesh.position[1]
        return col * (n_slots // s), (col + 1) * (n_slots // s)

    def gather_slots(self, local: torch.Tensor, n_slots: int,
                     slots: tuple[int, ...], cut=None) -> torch.Tensor:
        """(b, len(slots), ...) the wanted `slots` of every object, in
        `slots`' order, all-gathered over the shard row: each rank sends
        only the wanted slots it holds, each through `cut` (a function
        of the (b, held, L) rows) when given."""
        s = self.mesh.axis_size("shard")
        per = n_slots // s
        want = sorted(set(slots))
        if want and not 0 <= want[0] <= want[-1] < n_slots:
            raise ValueError(f"slots {slots} outside [0, {n_slots})")
        lo, hi = self.slot_range(n_slots)
        held = [x - lo for x in want if lo <= x < hi]
        counts = [sum(1 for x in want if c * per <= x < (c + 1) * per)
                  for c in range(s)]
        mine = local[:, held]
        if cut is not None:
            mine = cut(mine)
        got = torch.cat(self.mesh.all_gather(mine, "shard", self.wire,
                                             counts), dim=1)
        order = [want.index(x) for x in slots]
        return got if order == list(range(len(want))) else got[:, order]


def encode_all_chunks(coder, obj) -> torch.Tensor:
    """(n_chunks, chunk_len) dense stack of every chunk of one object —
    the bridge from a codec's dict-shaped encode() into the sharded mesh
    paths (and their tests), on the coder's device."""
    n = coder.get_chunk_count()
    enc = coder.encode(range(n), obj)
    return torch.stack([enc[i] for i in range(n)])


def default_mesh(devices=None, shard: int = 2, device=None) -> Mesh:
    """(dp, shard) mesh over the given ranks (default: the whole world).

    `shard` ranks hold disjoint subsets of each stripe's k+m chunks; the
    rest of the ranks form the batch-parallel axis. `shard` must divide
    the rank count — a silently different topology than the one the
    caller modeled would misplace every shard group.
    """
    devices = np.asarray(devices if devices is not None
                         else range(dist.get_world_size()))
    n = devices.size
    if shard < 1 or n % shard:
        raise ValueError(
            f"shard axis {shard} does not divide device count {n}; "
            f"pick a divisor (e.g. {[d for d in (1, 2, 4, 8) if n % d == 0]})")
    return Mesh(devices.reshape(n // shard, shard), device)


def chunk_sharding(mesh: Mesh) -> NamedSharding:
    """Layout of a (batch, n_chunks, L) chunk tensor: batch over dp,
    chunk slots over shard — each rank is an 'OSD group' holding its
    slice of every stripe."""
    return NamedSharding(mesh, ("dp", "shard", None))


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ("dp", None, None))


def padded_slots(n_chunks: int, mesh: Mesh) -> int:
    """Chunk-slot count padded up to a multiple of the shard axis so the
    slot axis divides evenly across ranks (empty tail slots are zero —
    the analog of unused placement slots, not of real shards)."""
    s = mesh.devices.shape[mesh.axis_names.index("shard")]
    return -(-n_chunks // s) * s


def make_sharded_encoder(matrix: np.ndarray, mesh: Mesh,
                         impl: str = DEFAULT_IMPL) -> Step:
    """Step: (B, k, L) data -> (B, padded_slots(k+m), L) chunks, sharded
    over (dp, shard) (the analog of MOSDECSubOpWrite fan-out). Slots >=
    k+m are zero padding. The input is data-sharded, so a rank computes
    its own slots from the data it holds and moves nothing: its parity
    slots are one gf_apply launch of their matrix rows."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    m, k = matrix.shape
    n = m + k
    slots = padded_slots(n, mesh)

    def body(step, data, shape):
        B, k_in, L = shape
        if k_in != k:
            raise ValueError(f"data has {k_in} shards, matrix expects {k}")
        lo, hi = step.slot_range(slots)
        out = torch.zeros((data.shape[0], hi - lo, L), dtype=torch.uint8,
                          device=data.device)
        if lo < k:
            out[:, :min(hi, k) - lo] = data[:, lo:min(hi, k)]
        p_lo, p_hi = max(lo, k), min(hi, n)
        if p_hi > p_lo:
            out[:, p_lo - lo:p_hi - lo] = apply_matrix(
                matrix[p_lo - k:p_hi - k], data, impl=impl)
        return out, (B, slots, L)

    return Step(mesh, ("dp", None, None), ("dp", "shard", None), body)


def make_sharded_gather_apply(D: np.ndarray, slots: tuple[int, ...],
                              mesh: Mesh, impl: str = DEFAULT_IMPL) -> Step:
    """Step: sharded (B, n_slots, L) chunks -> (B, rows(D), L), replicated
    over the shard axis.

    The shard row all-gathers exactly the given slots (the analog of
    MOSDECSubOpRead gather), then the static GF matrix runs batched on
    every dp slice. The building block for degraded decode, LRC local
    repair, and any derived linear repair (ec.linearize)."""
    D = np.asarray(D, dtype=np.uint8)
    idx = tuple(int(s) for s in slots)

    def body(step, chunks, shape):
        B, n_slots, L = shape
        got = step.gather_slots(chunks, n_slots, idx)
        return apply_matrix(D, got, impl=impl), (B, D.shape[0], L)

    return Step(mesh, ("dp", "shard", None), ("dp", None, None), body)


def make_sharded_decoder(matrix: np.ndarray, erasures: tuple[int, ...],
                         survivors: tuple[int, ...], mesh: Mesh,
                         impl: str = DEFAULT_IMPL) -> Step:
    """Step: sharded (B, n, L) chunks -> (B, E, L) reconstructed
    (degraded read across the mesh; see make_sharded_gather_apply)."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    k = matrix.shape[1]
    D = decode_matrix(matrix, list(erasures), k, list(survivors))
    return make_sharded_gather_apply(D, tuple(survivors), mesh, impl)


def make_sharded_clay_repair(coder, failed_chunk: int,
                             helper_chunks: tuple[int, ...], mesh: Mesh,
                             impl: str = DEFAULT_IMPL) -> Step:
    """Step: sharded (B, n_slots, L) chunks -> (B, L) rebuilt Clay
    chunk, sharded over dp. Each rank cuts the beta = q^(t-1) repair-plane
    sub-chunks of q^t out of its helper slots before the shard row
    gathers them (the MSR bandwidth win on the wire), then one static
    matrix-apply runs on every dp slice."""
    D, rplanes = coder.repair_plan_matrix(failed_chunk, helper_chunks)
    D = np.asarray(D, dtype=np.uint8)
    nsub = coder.get_sub_chunk_count()
    planes = torch.as_tensor(np.asarray(rplanes, dtype=np.int64))
    helpers = tuple(int(h) for h in helper_chunks)
    d, nrp = len(helpers), len(rplanes)

    def body(step, chunks, shape):
        B, n_slots, L = shape
        if L % nsub:
            raise ValueError(f"chunk length {L} is not a multiple of the "
                             f"{nsub} sub-chunks")
        sub = L // nsub

        def cut(rows):                                 # beta sub-chunks
            b, h = rows.shape[:2]
            return rows.reshape(b, h, nsub, sub)[
                :, :, planes.to(rows.device)].reshape(b, h, nrp * sub)

        got = step.gather_slots(chunks, n_slots, helpers, cut)
        stacked = got.reshape(got.shape[0], d * nrp, sub)
        out = apply_matrix(D, stacked, impl=impl)      # (b, nsub, sub)
        return out.reshape(out.shape[0], L), (B, L)

    return Step(mesh, ("dp", "shard", None), ("dp", None), body)


def virtual_mesh(n_devices: int, shard: int = 2, device=None) -> Mesh:
    """Mesh over the first n ranks of the running process group (every
    rank of the group constructs it; ranks past n are not in it)."""
    world = dist.get_world_size()
    if world < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {world}")
    return default_mesh(np.arange(n_devices), shard, device)
