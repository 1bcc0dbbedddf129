"""The (dp, sp) mesh as torch.distributed process groups, and the ZeRO
layout of the trainable tensors over dp.

JAX twin dynamicrafter_tpu/parallel/sharding.py. There one 2-axis device
mesh carries the data axis ('dp': training batches, the CFG passes at
inference) and the frame axis ('sp'), and XLA inserts the collectives. Here
each process drives one card (torchrun), the dp axis is a process group, and
the code calls the collectives itself:

  * `init_distributed` joins the group: nccl for CUDA, gloo for the CPU;
  * `create_mesh` checks the (dp, sp) shape against the world size, as the
    JAX function checks it against the devices; sp > 1 is not ported yet
    (ROADMAP Queue 1 item K) and raises;
  * `FlatShards` is the counterpart of `zero_spec`. JAX splits each leaf
    along its largest divisible dimension, a layout for XLA's partitioner.
    Here the tensors lie end to end in buckets, each padded to a multiple of
    dp and cut into dp equal pieces, so that one reduce-scatter and one
    all-gather serve a bucket rather than one of the UNet's ~1,400 tensors.

Without a mesh nothing here runs: single-process paths are untouched. Every
collective goes through this module and is counted in `collectives`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
SEQ_AXIS = "sp"
SP_NOT_PORTED = ("sequence parallelism (sp = {sp} > 1) is not ported yet: it is ROADMAP "
                 "Queue 1 item K. Shard the batch instead: --dp <number of processes>")
BUCKET_NUMEL = 1 << 26   # fp32 elements a bucket: 256 MB

# collective calls by kind since a caller last cleared it
collectives: collections.Counter = collections.Counter()

_state = threading.local()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, sp) mesh over `world_size` processes, this one `rank`. The
    collectives run over `group`, the dp axis's process group: while sp is
    1 the whole group (`dist.group.WORLD`; None without one)."""
    shape: Dict[str, int]
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]


def init_distributed(device="cuda", store_path: Optional[str] = None) -> torch.device:
    """Join the process group of a torchrun launch and return this process's
    device. Rank and world size come from RANK and WORLD_SIZE, the card from
    LOCAL_RANK; the backend is nccl for a CUDA device and gloo for the CPU.
    The rendezvous is a FileStore at `store_path` where one is given (no port
    to choose), else MASTER_ADDR / MASTER_PORT, which torchrun sets. An
    existing group is kept when its backend is the one the device needs;
    another backend raises."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", str(rank))))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group exists, but {device} "
                               f"needs {backend}")
        return device
    kw = dict(backend=backend, rank=rank, world_size=world)
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        kw["init_method"] = "env://"
    else:
        raise RuntimeError("no rendezvous for the process group: run under torchrun (it sets "
                           "MASTER_ADDR and MASTER_PORT) or give a FileStore path")
    if device.type == "cuda":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return device


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def create_mesh(dp: int = 1, sp: int = -1, world_size: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """A (dp, sp) mesh over the process group (or `world_size` processes);
    sp=-1 takes the processes dp leaves."""
    joined = dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if joined else 1)
    if rank is None:
        rank = dist.get_rank() if joined else 0
    if sp == -1:
        assert n % dp == 0, f"{n} processes not divisible by dp={dp}"
        sp = n // dp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} processes"
    if sp > 1:
        raise NotImplementedError(SP_NOT_PORTED.format(sp=sp))
    return Mesh({DATA_AXIS: dp, SEQ_AXIS: sp}, rank, n, dist.group.WORLD if joined else None)


def active_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def shard_bounds(n: int, dp: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of the elements of a flat buffer of n that rank `rank` of dp
    owns: pieces of ceil(n / dp), the last ones short or empty (the padding
    to dp * ceil(n / dp))."""
    per = -(-n // dp)
    lo = min(n, rank * per)
    return lo, min(n, lo + per)


# -- collectives -------------------------------------------------------------

def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, mesh: Mesh) -> None:
    collectives["reduce_scatter"] += 1
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, op=dist.ReduceOp.SUM, group=mesh.group)


def _all_gather(out: torch.Tensor, inp: torch.Tensor, mesh: Mesh) -> None:
    collectives["all_gather"] += 1
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=mesh.group)


def all_reduce(x: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """x summed (or its max) over the ranks, in place."""
    collectives["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=mesh.group)
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x (the same shape on each) stacked along dim 0 in rank
    order."""
    out = x.new_empty((mesh.dp * x.shape[0], *x.shape[1:]))
    _all_gather(out, x.contiguous(), mesh)
    return out


def barrier(mesh: Mesh) -> None:
    collectives["barrier"] += 1
    dist.barrier(group=mesh.group)


def gather_objects(value, mesh: Mesh) -> list:
    """Every rank's `value` (any picklable object), in rank order."""
    collectives["all_gather_object"] += 1
    out = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(out, value, group=mesh.group)
    return out


def dp_mean(values: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over the dp ranks of each 0-d tensor, in one all-reduce."""
    keys = list(values)
    stacked = all_reduce(torch.stack([values[k].float() for k in keys]), mesh) / mesh.dp
    return dict(zip(keys, stacked.unbind()))


def any_rank(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank if `flag` is true on some rank."""
    x = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    return bool(all_reduce(x, mesh, "max").item())


# -- the ZeRO layout ---------------------------------------------------------

class _Bucket(NamedTuple):
    start: int      # tensors [start, stop)
    stop: int
    n: int          # elements of those tensors
    offset: int     # where this rank's piece starts in the shard
    per: int        # ceil(n / dp): the piece's length, padding included
    first: int      # this rank's pieces of the bucket: spec[first:last]
    last: int


class FlatShards:
    """The ZeRO layout of a list of tensors over the dp axis of `mesh`.

    The tensors lie end to end in buckets of at most `bucket_numel` elements
    (a larger tensor is a bucket of its own). A bucket of n elements is
    padded to dp * ceil(n / dp) and rank r owns piece r. This rank's shard
    is its piece of every bucket, one after another: a flat fp32 buffer of
    `numel` elements on the tensors' device, the tensors' elements that
    `spec` lists and then padding, which stays zero. `views(tensors)` and
    `pieces(shard)` pair each own element of the tensors with its place in a
    shard."""

    def __init__(self, tensors: Sequence[torch.Tensor], mesh: Mesh,
                 bucket_numel: int = BUCKET_NUMEL):
        self.mesh = mesh
        self.device = tensors[0].device
        self.shapes = [t.shape for t in tensors]
        self.numels = [t.numel() for t in tensors]
        self.buckets: List[_Bucket] = []
        self.spec: List[Tuple[int, int, int]] = []   # (tensor, lo, hi) in shard order
        self._offsets: List[int] = []                # each spec entry's place in the shard
        i = off = 0
        while i < len(tensors):
            j, n = i + 1, self.numels[i]
            while j < len(tensors) and n + self.numels[j] <= bucket_numel:
                n += self.numels[j]
                j += 1
            lo, hi = shard_bounds(n, mesh.dp, mesh.rank)
            first, base, o = len(self.spec), 0, off
            for k in range(i, j):
                a, b = max(lo, base), min(hi, base + self.numels[k])
                if a < b:
                    self.spec.append((k, a - base, b - base))
                    self._offsets.append(o)
                    o += b - a
                base += self.numels[k]
            per = -(-n // mesh.dp)
            self.buckets.append(_Bucket(i, j, n, off, per, first, len(self.spec)))
            off += per
            i = j
        self.numel = off

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.numel, dtype=torch.float32, device=self.device)

    def views(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's elements of full-size `tensors`, as flat views."""
        return [tensors[k].view(-1)[a:b] for k, a, b in self.spec]

    def pieces(self, shard: torch.Tensor) -> List[torch.Tensor]:
        """The views of `shard` that hold what `views` returns, padding left
        out."""
        return [shard[o:o + b - a] for (_, a, b), o in zip(self.spec, self._offsets)]

    @torch.no_grad()
    def shard_of(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """A new shard holding this rank's elements of full-size `tensors`
        (on any device)."""
        shard = self.zeros()
        for piece, (k, a, b) in zip(self.pieces(shard), self.spec):
            piece.copy_(tensors[k].reshape(-1)[a:b])
        return shard

    @torch.no_grad()
    def reduce_scatter(self, grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """This rank's shard of the dp mean of `grads`, one full-size fp32
        gradient a tensor on every rank. Consumes `grads`: each entry is set
        to None once it is copied into its bucket, so the buckets replace the
        gradients rather than add to them."""
        shard, dp = torch.empty(self.numel, dtype=torch.float32, device=self.device), self.mesh.dp
        for bk in self.buckets:
            parts = [grads[k].reshape(-1) for k in range(bk.start, bk.stop)]
            if bk.per * dp > bk.n:
                parts.append(shard.new_zeros(bk.per * dp - bk.n))
            flat = torch.cat(parts) if len(parts) > 1 else parts[0]
            del parts
            grads[bk.start:bk.stop] = [None] * (bk.stop - bk.start)
            _reduce_scatter(shard[bk.offset:bk.offset + bk.per], flat, self.mesh)
            del flat
        if dp > 1:
            shard.div_(dp)
        return shard

    def _gather(self, bk: _Bucket, inp: torch.Tensor) -> torch.Tensor:
        out = inp.new_empty(bk.per * self.mesh.dp)
        _all_gather(out, inp, self.mesh)
        return out[:bk.n]

    @torch.no_grad()
    def gather_into(self, tensors: Sequence[torch.Tensor],
                    source: Optional[torch.Tensor] = None) -> None:
        """Fill full-size `tensors` in place from every rank's shard of
        `source`, or, without one, from every rank's own elements of
        `tensors` (after each rank updated its own in place)."""
        for bk in self.buckets:
            if source is not None:
                inp = source[bk.offset:bk.offset + bk.per]
            else:
                own = [tensors[k].view(-1)[a:b] for k, a, b in self.spec[bk.first:bk.last]]
                pad = bk.per - sum(v.numel() for v in own)
                if pad:
                    own.append(tensors[bk.start].new_zeros(pad))
                inp = torch.cat(own)
            full = self._gather(bk, inp)
            torch._foreach_copy_([tensors[k].view(-1) for k in range(bk.start, bk.stop)],
                                 list(full.split(self.numels[bk.start:bk.stop])))

    @torch.no_grad()
    def gather(self, source: torch.Tensor, device=None,
               root: Optional[int] = None) -> Optional[List[torch.Tensor]]:
        """The full-size tensors (in the layout's shapes) whose shards every
        rank holds in `source`, as new tensors on `device` (default: the
        shard's). With `root` only that rank keeps them: the others make the
        same collective calls, hold one bucket at a time, and get None."""
        keep = root is None or root == self.mesh.rank
        out = []
        for bk in self.buckets:
            full = self._gather(bk, source[bk.offset:bk.offset + bk.per])
            if keep:
                out += [x.view(self.shapes[k]).to(device or self.device, copy=True)
                        for k, x in zip(range(bk.start, bk.stop),
                                        full.split(self.numels[bk.start:bk.stop]))]
            del full
        return out if keep else None

    @torch.no_grad()
    def norm(self, shard: torch.Tensor) -> torch.Tensor:
        """The L2 norm of the full-size tensors whose shards the ranks hold
        in `shard` (0-d, the same on every rank)."""
        sq = torch.linalg.vector_norm(shard).square().reshape(1)
        return all_reduce(sq, self.mesh).sqrt()[0]
