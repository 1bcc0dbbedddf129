"""The (dp, sp) mesh as torch.distributed process groups, and the ZeRO
layout of the trainable tensors over dp.

JAX twin dynamicrafter_tpu/parallel/sharding.py. There one 2-axis device
mesh carries the data axis ('dp': training batches, the CFG passes at
inference) and the frame axis ('sp'), and XLA inserts the collectives. Here
each process drives one card (torchrun), the dp axis is a process group, and
the code calls the collectives itself:

  * `init_distributed` joins the group: nccl for CUDA, gloo for the CPU
    (or the backend asked for: gloo carries CUDA tensors too, through host
    memory, which is how several ranks share one card);
  * `create_mesh` checks the (dp, sp) shape against the world size, as the
    JAX function checks it against the devices, and makes one process group
    per row and per column of the (dp, sp) grid;
  * the sp axis (a clip's frames split over the ranks of an sp group) has
    its collectives written out, each an autograd Function whose backward is
    the adjoint collective: `frames_to_tokens` / `tokens_to_frames` (the
    T <-> HW all-to-all around each TemporalTransformer), `halo` (the
    neighbours' boundary frames of each temporal conv), `sp_all_reduce` (the
    per-clip statistics) and `sp_gather_frames` (outputs, and the stages
    that run replicated). `use_frames` / `active_frames` carry the split of
    one clip (`FrameSplit`) from a sampler or trainer to the UNet, which
    hands it to its layers as an argument;
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
BUCKET_NUMEL = 1 << 26   # fp32 elements a bucket: 256 MB

# collective calls by kind since a caller last cleared it
collectives: collections.Counter = collections.Counter()

_state = threading.local()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, sp) mesh over `world_size` processes, this one `rank`, at
    (dp_rank, sp_rank) = divmod(rank, sp): the row-major order of JAX's
    `devices.reshape(dp, sp)`. The dp collectives run over `group`, the
    ranks that share sp_rank (while sp is 1 the whole group,
    `dist.group.WORLD`); the sp ones over `sp_group`, the ranks that share
    dp_rank. Both are None without a process group."""
    shape: Dict[str, int]
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None
    sp_group: Optional[object] = None

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def sp(self) -> int:
        return self.shape[SEQ_AXIS]

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp


def init_distributed(device="cuda", store_path: Optional[str] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group of a torchrun launch and return this process's
    device. Rank and world size come from RANK and WORLD_SIZE, the card from
    LOCAL_RANK; the backend is `backend`, by default nccl for a CUDA device
    and gloo for the CPU (gloo on CUDA tensors lets ranks share a card,
    which nccl refuses). The rendezvous is a FileStore at `store_path` where
    one is given (no port to choose), else MASTER_ADDR / MASTER_PORT, which
    torchrun sets. An existing group is kept unless another `backend` was
    asked for, which raises."""
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", str(rank))))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group exists, but {backend} "
                               "was asked for")
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = dict(backend=backend, rank=rank, world_size=world)
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world)
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        kw["init_method"] = "env://"
    else:
        raise RuntimeError("no rendezvous for the process group: run under torchrun (it sets "
                           "MASTER_ADDR and MASTER_PORT) or give a FileStore path")
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)
    return device


def destroy_distributed() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def create_mesh(dp: int = 1, sp: int = -1, world_size: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """A (dp, sp) mesh over the process group (or `world_size` processes);
    sp=-1 takes the processes dp leaves. With a process group every rank
    makes the same `new_group` calls in the same order (they are
    collective): one dp group per sp position, then one sp group per dp
    position, the whole group standing in for an axis that spans it."""
    joined = dist.is_initialized()
    n = world_size if world_size is not None else (dist.get_world_size() if joined else 1)
    if rank is None:
        rank = dist.get_rank() if joined else 0
    if sp == -1:
        assert n % dp == 0, f"{n} processes not divisible by dp={dp}"
        sp = n // dp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} processes"
    shape = {DATA_AXIS: dp, SEQ_AXIS: sp}
    if not joined:
        return Mesh(shape, rank, n)
    grid = [[d * sp + s for s in range(sp)] for d in range(dp)]

    def groups(rows):
        # every rank makes every group, in one order
        made = [dist.group.WORLD if len(r) == n else dist.new_group(r) for r in rows]
        return next(g for g, r in zip(made, rows) if rank in r)

    dp_group = groups([[grid[d][s] for d in range(dp)] for s in range(sp)])
    sp_group = groups(grid) if sp > 1 else None
    return Mesh(shape, rank, n, dp_group, sp_group)


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
    """Every rank of the mesh (both axes) waits for the others."""
    collectives["barrier"] += 1
    dist.barrier()


def gather_objects(value, mesh: Mesh) -> list:
    """Every rank's `value` (any picklable object), in rank order over the
    whole mesh."""
    collectives["all_gather_object"] += 1
    out = [None] * mesh.world_size
    dist.all_gather_object(out, value)
    return out


def dp_mean(values: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over the dp ranks of each 0-d tensor, in one all-reduce."""
    keys = list(values)
    stacked = all_reduce(torch.stack([values[k].float() for k in keys]), mesh) / mesh.dp
    return dict(zip(keys, stacked.unbind()))


def any_rank(flag: bool, mesh: Mesh, device) -> bool:
    """True on every rank of the mesh if `flag` is true on some rank."""
    x = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    collectives["all_reduce"] += 1
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return bool(x.item())


# -- the sp axis -------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class FrameSplit:
    """A clip of `t` frames split over the sp ranks of `mesh`: this rank
    holds frames [lo, lo + local) of every clip (the JAX layout's T on
    'sp'). Made by `split_frames`, which returns None where sp does not
    divide t: the clip then stays whole on every rank, as JAX's `constrain`
    drops an axis that does not divide (its parallel/sharding.py:118-135)."""
    mesh: Mesh
    t: int

    @property
    def sp(self) -> int:
        return self.mesh.sp

    @property
    def local(self) -> int:
        return self.t // self.sp

    @property
    def lo(self) -> int:
        return self.mesh.sp_rank * self.local

    def slice(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's frames of a whole clip `x` (frames at `dim`)."""
        return x.narrow(dim, self.lo, self.local)


def split_frames(t: int, mesh: Optional[Mesh] = None) -> Optional[FrameSplit]:
    """The split of a clip of `t` frames over the sp axis of `mesh` (default:
    the active one), or None: no mesh, sp = 1, or sp does not divide t."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.sp == 1 or t % mesh.sp:
        return None
    return FrameSplit(mesh, t)


def active_frames() -> Optional[FrameSplit]:
    return getattr(_state, "frames", None)


@contextlib.contextmanager
def use_frames(split: Optional[FrameSplit]):
    """While active, a sampler's or trainer's clip tensors hold this rank's
    frames of `split` (None: whole clips). The UNet reads it once a call and
    passes it to its layers (a checkpointed layer is recomputed on autograd's
    thread, which would not see this thread-local state)."""
    prev = active_frames()
    _state.frames = split
    try:
        yield split
    finally:
        _state.frames = prev


def randn_frames(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard normal noise shaped like `like` (frames at dim 1). Under an
    active split the whole clip's noise is drawn and this rank's frames
    kept, so that every rank draws what one process would."""
    split = active_frames()
    shape = like.shape if split is None else (like.shape[0], split.t, *like.shape[2:])
    noise = torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)
    return noise if split is None else split.slice(noise)


def _all_to_all(out: torch.Tensor, inp: torch.Tensor, split: FrameSplit, kind: str,
                out_splits=None, in_splits=None) -> None:
    collectives[kind] += 1
    dist.all_to_all_single(out, inp, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=split.mesh.sp_group)


def _exchange(split: FrameSplit):
    """The sp all-to-all of a tensor in the wire layout (sp pieces at dim 0,
    piece j to sp rank j)."""
    def run(inp: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(inp)
        _all_to_all(out, inp, split, "sp_all_to_all")
        return out
    return run


def _t_to_hw(x: torch.Tensor, sp: int, exchange) -> torch.Tensor:
    """(B, T/sp, HW, C) -> (B, T, HW/sp, C): HW piece j goes to sp rank j
    through `exchange`. The two layout copies (into and out of the wire
    layout) are this function's own work."""
    b, tl, n, c = x.shape
    out = exchange(x.reshape(b, tl, sp, n // sp, c).permute(2, 0, 1, 3, 4).contiguous())
    # out[i]: sp rank i's frames at this rank's HW piece
    return out.permute(1, 0, 2, 3, 4).reshape(b, sp * tl, n // sp, c)


def _hw_to_t(y: torch.Tensor, sp: int, exchange) -> torch.Tensor:
    """(B, T, HW/sp, C) -> (B, T/sp, HW, C), the inverse of `_t_to_hw`."""
    b, t, m, c = y.shape
    out = exchange(y.reshape(b, sp, t // sp, m, c).permute(1, 0, 2, 3, 4).contiguous())
    # out[i]: this rank's frames at sp rank i's HW piece
    return out.permute(1, 2, 0, 3, 4).reshape(b, t // sp, sp * m, c)


class _FramesToTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return _t_to_hw(x, split.sp, _exchange(split))

    @staticmethod
    def backward(ctx, g):
        return _hw_to_t(g, ctx.split.sp, _exchange(ctx.split)), None


class _TokensToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, split):
        ctx.split = split
        return _hw_to_t(y, split.sp, _exchange(split))

    @staticmethod
    def backward(ctx, g):
        return _t_to_hw(g, ctx.split.sp, _exchange(ctx.split)), None


def frames_to_tokens(x: torch.Tensor, split: FrameSplit) -> torch.Tensor:
    """This rank's frames (B, T/sp, HW, C) -> every frame at this rank's
    HW / sp positions (B, T, HW/sp, C): one all-to-all over the sp group.
    sp must divide HW."""
    return _FramesToTokens.apply(x, split)


def tokens_to_frames(y: torch.Tensor, split: FrameSplit) -> torch.Tensor:
    """The inverse of `frames_to_tokens`: (B, T, HW/sp, C) -> (B, T/sp, HW, C)."""
    return _TokensToFrames.apply(y, split)


def _halo_exchange(first: torch.Tensor, last: torch.Tensor, split: FrameSplit):
    """Send `first` to the previous sp rank and `last` to the next one (one
    all-to-all whose split sizes are zero but for the neighbours); returns
    (what the previous rank sent, what the next one sent), zeros at the
    clip's ends."""
    r, sp = split.mesh.sp_rank, split.sp
    sizes = [int(j in (r - 1, r + 1)) for j in range(sp)]
    rows = ([first] if r > 0 else []) + ([last] if r < sp - 1 else [])
    inp = torch.stack([a.reshape(-1) for a in rows])
    out = torch.empty_like(inp)
    _all_to_all(out, inp, split, "sp_halo", sizes, sizes)
    prev = out[0].view_as(first) if r > 0 else torch.zeros_like(first)
    nxt = out[-1].view_as(last) if r < sp - 1 else torch.zeros_like(last)
    return prev, nxt


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim, ctx.n = split, dim, x.shape[dim]
        return _halo_exchange(x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1), split)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # each gradient goes back to the rank whose frame it is and adds there
        to_first, to_last = _halo_exchange(g_prev.contiguous(), g_next.contiguous(), ctx.split)
        shape = list(g_prev.shape)
        shape[ctx.dim] = ctx.n
        grad = g_prev.new_zeros(shape)
        grad.narrow(ctx.dim, 0, 1).add_(to_first)
        grad.narrow(ctx.dim, ctx.n - 1, 1).add_(to_last)
        return grad, None, None


def halo(x: torch.Tensor, split: FrameSplit, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frames just outside this rank's frames of `x` along `dim`: the
    previous sp rank's last frame and the next one's first, each of size 1
    at `dim`, zeros at the clip's two ends (a kernel-3 conv's zero padding
    there)."""
    return _Halo.apply(x, split, dim)


class _SpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        out = x.clone()
        collectives["sp_all_reduce"] += 1
        dist.all_reduce(out, group=split.mesh.sp_group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum: each input gets the sum of them
        g = g.clone()
        collectives["sp_all_reduce"] += 1
        dist.all_reduce(g, group=ctx.split.mesh.sp_group)
        return g, None


def sp_all_reduce(x: torch.Tensor, split: FrameSplit) -> torch.Tensor:
    """The sum of `x` over the sp group (a new tensor; differentiable)."""
    return _SpAllReduce.apply(x, split)


def _gather_frames(x: torch.Tensor, split: FrameSplit, dim: int) -> torch.Tensor:
    inp = x.movedim(dim, 0).contiguous()
    out = inp.new_empty((split.sp * inp.shape[0], *inp.shape[1:]))
    collectives["sp_all_gather"] += 1
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=split.mesh.sp_group)
    return out.movedim(0, dim)


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim = split, dim
        return _gather_frames(x, split, dim)

    @staticmethod
    def backward(ctx, g):
        # the adjoint: each rank's frames get the sum of every rank's gradient
        inp = g.movedim(ctx.dim, 0).contiguous()
        out = inp.new_empty((inp.shape[0] // ctx.split.sp, *inp.shape[1:]))
        collectives["sp_reduce_scatter"] += 1
        fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        fn(out, inp, op=dist.ReduceOp.SUM, group=ctx.split.mesh.sp_group)
        return out.movedim(0, ctx.dim), None, None


def sp_gather_frames(x: torch.Tensor, split: FrameSplit, dim: int = 1) -> torch.Tensor:
    """The whole clip from every sp rank's frames of `x` along `dim`, on
    every rank (differentiable). Outside the UNet: decoded frames and
    sampled latents; inside it only where a stage runs replicated."""
    return _GatherFrames.apply(x, split, dim)


def _buckets(numels: Sequence[int], limit: int) -> List[Tuple[int, int]]:
    """[start, stop) of each bucket: consecutive tensors of `numels` packed
    greedily while they hold at most `limit` elements together (a larger
    tensor is a bucket of its own)."""
    out, i = [], 0
    while i < len(numels):
        j, n = i + 1, numels[i]
        while j < len(numels) and n + numels[j] <= limit:
            n += numels[j]
            j += 1
        out.append((i, j))
        i = j
    return out


@torch.no_grad()
def sp_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh,
            bucket_numel: int = BUCKET_NUMEL) -> None:
    """Sum each tensor over the sp group of `mesh`, in place: one all-reduce
    a flat bucket of at most `bucket_numel` elements (a larger tensor is a
    bucket of its own)."""
    for i, j in _buckets([t.numel() for t in tensors], bucket_numel):
        flat = torch.cat([t.reshape(-1) for t in tensors[i:j]])
        collectives["sp_all_reduce"] += 1
        dist.all_reduce(flat, group=mesh.sp_group)
        torch._foreach_copy_([t.view(-1) for t in tensors[i:j]],
                             list(flat.split([t.numel() for t in tensors[i:j]])))


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
        off = 0
        for i, j in _buckets(self.numels, bucket_numel):
            n = sum(self.numels[i:j])
            lo, hi = shard_bounds(n, mesh.dp, mesh.dp_rank)
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
        keep = root is None or root == self.mesh.rank   # a global rank
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
