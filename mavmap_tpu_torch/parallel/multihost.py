"""Ranks, their process group and the collectives of the distributed path.

Port of mavmap_tpu/parallel/multihost.py. The JAX package runs one
controller over a jax.sharding.Mesh and reduces with jax.lax.psum; here
every rank is a process of its own (torch.distributed), runs the same
sequential mapper on host state that every rank holds alike, and the
sharded steps exchange their blocks through the collectives of `Mesh`:

  - `init_multihost`: init_process_group under the JAX function's
    arguments (rank 0's "host:port", the process count, this process's
    index, its local device ids) plus this rank's device and backend
    (idempotent; nothing to do with one process). The device is the card
    unless the caller names another. The backend follows the layout and
    is chosen before the group starts: NCCL on device tensors where every
    rank has a CUDA device of its own, gloo on host copies where ranks
    share a card or run on the CPU (NCCL refuses two ranks on one device,
    and gloo has no CUDA all_gather). A backend that fails to start
    raises.
  - `Mesh`: the group, this rank, the rank count and this rank's device.
    `psum` is an all_gather followed by a sum over the rank axis in rank
    order 0..N-1, so every rank gets the same bits and a run repeats bit
    for bit (all_reduce fixes no order for more than 2 ranks).
  - `global_mesh`, `process_shard_bounds`, `host_local_to_global`: the
    JAX helpers' counterparts; with one process they reduce to the whole
    range and the identity.
  - `launch(fn, n, device)`: runs fn(mesh, *args) on n ranks started with
    the spawn context (fork after CUDA has started fails), rank r on
    cuda:{r % device_count} or on the CPU. The kernels are built in the
    launching process first, so the ranks do not race the build. A rank
    that raises or dies fails the launch: the others are killed, and the
    launch raises.
"""

import hashlib
import os
import queue
import socket
import time
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# The process group's collective timeout: a rank that dies or hangs
# surfaces as an error in the others within this many seconds.
GROUP_TIMEOUT_S = 120


def free_port():
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(device, local_ranks):
    """NCCL where each of the host's `local_ranks` ranks has a CUDA device
    of its own, gloo otherwise (ranks sharing a card, or the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _local_device(device=None, local_device_ids=None):
    """This rank's device: `device` where given, else the card
    cuda:local_device_ids[0] (the JAX package's local device ids; a rank
    here drives one device), else cuda:{LOCAL_RANK % device_count} (the
    launcher's local rank, or the current card). Raises where a CUDA
    device is asked for and there is none."""
    if device is None:
        if local_device_ids is not None:
            if len(local_device_ids) != 1:
                raise ValueError(f"init_multihost: local_device_ids={local_device_ids}: "
                                 "each rank drives one device")
            device = torch.device("cuda", int(local_device_ids[0]))
        else:
            device = torch.device("cuda")
    device = resolve_device(device, "parallel")
    if device.type == "cuda" and device.index is None:
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) % torch.cuda.device_count()
                              if local is not None else torch.cuda.current_device())
    return device


def init_multihost(coordinator_address=None, num_processes=None, process_id=None,
                   local_device_ids=None, *, device=None, backend=None,
                   timeout_s=GROUP_TIMEOUT_S):
    """Start the default process group (idempotent; a no-op for one
    process), under the JAX package's names: coordinator_address
    "host:port" of rank 0's rendezvous, or None for the environment a
    launcher such as torchrun sets (MASTER_ADDR, RANK, WORLD_SIZE,
    LOCAL_WORLD_SIZE); num_processes and process_id the world size and this
    rank (None: from that environment); local_device_ids / device this
    rank's device (_local_device; the card by default). The backend, where
    not given, follows the layout (choose_backend); it is printed by rank
    0. Returns (rank, world_size)."""
    device = _local_device(device, local_device_ids)
    world_size, rank = num_processes, process_id
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return 0, 1
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = choose_backend(device, local)
    kw = {"device_id": device} if backend == "nccl" else {}
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kw)
    if rank == 0:
        layout = ("one CUDA device per rank" if backend == "nccl" else
                  "ranks sharing a CUDA device, host-staged collectives"
                  if device.type == "cuda" else "CPU ranks")
        print(f"torch.distributed: {world_size} ranks, backend {backend} ({layout})",
              flush=True)
    return rank, world_size


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the ranks: the process group (None with one
    process), this rank, the rank count, this rank's device and the axis
    name. `stats` accumulates the host seconds spent in collectives and
    their count."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "obs"
    stats: dict = field(default_factory=lambda: {"collective_s": 0.0, "collectives": 0},
                        compare=False)

    @property
    def staged(self):
        """True where collectives run on host copies (gloo)."""
        return self.group is not None and dist.get_backend(self.group) != "nccl"

    def all_gather(self, t):
        """[rank 0's t, ..., rank N-1's t] on this rank's device (t has the
        same shape and dtype on every rank)."""
        if self.size == 1:
            return [t]
        if self.device.type == "cuda" and self.staged:
            # Wait for the tensor here rather than inside the copy, so that
            # the collective's host time does not hold the device's work.
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        src = t.detach().contiguous()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        if self.staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        parts = [p.to(self.device).to(t.dtype) for p in parts]
        self.stats["collective_s"] += time.perf_counter() - t0
        self.stats["collectives"] += 1
        return parts

    def psum(self, t):
        """The sum of t over the ranks, added in rank order 0..N-1: the same
        bits on every rank (jax.lax.psum's counterpart)."""
        if self.size == 1:
            return t
        parts = self.all_gather(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc

    def block(self, n):
        """[lo, hi) of this rank's block when n items are split in rank
        order into blocks of ceil(n / size) (the last ones may be short or
        empty)."""
        per = -(-n // self.size)
        return min(self.rank * per, n), min((self.rank + 1) * per, n)

    def gather_blocks(self, t, n):
        """Every rank's block (t: this rank's rows of `block(n)`) joined in
        rank order into the n rows of the whole, on every rank."""
        if self.size == 1:
            return t
        per = -(-n // self.size)
        pad = torch.zeros((per - t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        return torch.cat(self.all_gather(torch.cat([t, pad])))[:n]

    def barrier(self):
        if self.size > 1:
            dist.barrier(group=self.group)

    def check_same(self, what, values):
        """Raise on every rank unless every rank holds the same `values`
        (float64 digests of state that the ranks hold alike), bit for
        bit."""
        if self.size == 1:
            return
        mine = torch.as_tensor(np.asarray(values, np.float64))
        rows = self.all_gather(mine.to(self.device))
        bits = [r.cpu().view(torch.int64) for r in rows]
        bad = [r for r in range(self.size) if not torch.equal(bits[r], bits[0])]
        if bad:
            raise RuntimeError(
                f"ranks drifted apart after {what}: rank 0 holds {rows[0].tolist()}, "
                + "; ".join(f"rank {r} {rows[r].tolist()}" for r in bad))


def digest(*arrays):
    """float64 numbers summarising host arrays, for Mesh.check_same: each
    array's float64 sum, and a 48-bit hash of its bytes (exact in float64)."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        out.append(float(np.sum(a, dtype=np.float64)) if a.dtype.kind in "fiub" else 0.0)
        out.append(float(int.from_bytes(hashlib.sha256(a.tobytes()).digest()[:6], "little")))
    return out


def global_mesh(axis="obs", devices=None, *, device=None):
    """This rank's Mesh over every rank of the default group; with one
    process (no group), a mesh of one rank. devices: the ranks' devices in
    rank order (this rank takes its own), or device: this rank's; neither:
    the card (_local_device)."""
    if device is None and devices is not None:
        device = devices[dist.get_rank() if dist.is_initialized() else 0]
    device = _local_device(device)
    if not dist.is_initialized():
        return Mesh(None, 0, 1, device, axis)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device, axis)


def process_shard_bounds(n_items, mesh):
    """[lo, hi) of the n_items that this rank owns when they are split
    equally over the ranks (n_items pre-padded to a multiple of the rank
    count, as partition_problem does): the JAX helper's range for one
    device per process."""
    per = n_items // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def host_local_to_global(mesh, arr, axis="obs"):
    """This rank's block of a sharded array, on its device; `axis` must
    name the mesh's axis, as in the JAX package. There is no global array
    object across processes here: each rank keeps its block, and the
    collectives join blocks where a whole is needed. With one process the
    block is the whole array (the identity)."""
    if axis != mesh.axis:
        raise ValueError(f"host_local_to_global: axis {axis!r}, the mesh's is {mesh.axis!r}")
    return torch.as_tensor(np.asarray(arr), device=mesh.device)


def _rank_main(rank, n, coordinator_address, device_type, threads, fn, args, results):
    """One rank of `launch`: start the group, run fn(mesh, *args) and put
    (rank, result) on `results` (a raised exception reaches the launcher
    through torch.multiprocessing's error file, which the launcher reads
    before the other ranks notice that this one has gone)."""
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(threads)
    init_multihost(coordinator_address, n, rank, device=device)
    results.put((rank, fn(global_mesh(device=device), *args)))
    dist.destroy_process_group()


def launch(fn, n, device="cuda", args=(), timeout=None, threads=None):
    """Run fn(mesh, *args) on n ranks, spawned processes joined by a gloo or
    NCCL group on localhost (see init_multihost); returns the ranks' results
    in rank order. `fn` and `args` must pickle (fn by its import path).
    device: "cuda" (rank r on cuda:{r % device_count}) or "cpu" (each rank
    with `threads` threads, default this process's count // n). A rank that
    raises or dies fails the launch: the other ranks are killed and
    RuntimeError raised with the rank's traceback; so does the launch not
    ending within `timeout` seconds (None: no limit)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: no CUDA device")
        # Built here, once: the ranks load what this process built.
        from .. import native
        from ..ops.cuda import build

        build.build()
        native.build()
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    results = mp.get_context("spawn").Queue()
    address = f"localhost:{free_port()}"
    ctx = mp.start_processes(_rank_main, (n, address, device_type, threads, fn, args,
                                          results), nprocs=n, join=False, daemon=True)
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}
    try:
        done = False
        while not done:
            try:
                done = ctx.join(timeout=0.5)
            except ProcessException as e:
                raise RuntimeError(f"launch: rank {e.error_index} failed: {e}") from None
            # Read results as they come: a rank exits once its result is read.
            while len(out) < n:
                try:
                    rank, val = results.get(timeout=2.0 if done else 0.01)
                except queue.Empty:
                    break
                out[rank] = val
            if not done and deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"launch: the ranks did not finish within {timeout} s; "
                                   f"ranks {sorted(set(range(n)) - set(out))} pending")
        missing = sorted(set(range(n)) - set(out))
        if missing:
            raise RuntimeError(f"launch: ranks {missing} exited without a result")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [out[r] for r in range(n)]
