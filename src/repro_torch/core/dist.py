"""Distribution context of the update methods, the port of
``repro.core.dist`` on ``torch.distributed``.

``DistCtx`` lets the update methods be written once for one device and for
a data-parallel group. With an axis, the group is the initialized default
process group (one rank a device; NCCL on the card, gloo on the CPU): each
rank encodes its local shard of the batch, all-gathers the representations
(cross-device in-batch negatives) and computes the loss over its own rows
only. Gradients flow through the all-gather (its backward sums every rank's
cotangent and keeps this rank's slice, the transpose of JAX's
``all_gather``), after which one all-reduce of the gradients gives the
gradient of the global-batch loss.

Without an axis every collective is the identity. With one, every
collective goes through the group, at world size 1 too, except
``ring_rotate``: torch refuses a send to oneself, and a rotation of a
one-rank ring is the identity. ``broadcast`` has no JAX twin: JAX serves
from one controller, the port from one process a rank, so rank 0's
coalesced serving batch has to reach the other ranks
(``retrieval/serving.py``). Building a context with an axis and no
initialized process group raises; there is no fallback.

Each collective adds one to its kind's count in ``collectives`` (per call,
not per tensor), so a run can show which collectives carried it;
``reset_collectives()`` zeroes them.

``spawn_ranks`` starts the ranks of the launch drivers' ``--dp N``
(``launch/train.py``, ``launch/serve.py``): N processes on one group over a
``FileStore`` in a temporary directory (no network), one a GPU under NCCL or
gloo ranks of one torch thread on the CPU.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.treemath import tree_leaves, tree_map

KINDS = ("all_gather", "all_reduce", "ring", "broadcast")

#: collective calls by kind since the last ``reset_collectives()``
collectives = dict.fromkeys(KINDS, 0)

#: the longest a serving rank waits in one collective (a follower waits for
#: the next batch in one)
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def reset_collectives() -> None:
    """Set every count of ``collectives`` to 0."""
    collectives.update(dict.fromkeys(KINDS, 0))


def _replace_leaves(tree, leaves, new):
    """``tree`` with each of its ``leaves`` (``tree_leaves(tree)``) swapped
    for the tensor at the same place in ``new``."""
    by_id = {id(old): n for old, n in zip(leaves, new)}
    return tree_map(lambda t: by_id[id(t)], tree)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as the collectives carry it: bool as uint8 (NCCL has no bool)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    world = dist.get_world_size()
    w = _wire(x)
    out = torch.empty((world * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)
    gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_single(out, w)
    collectives["all_gather"] += 1
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _all_reduce_(buf: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    collectives["all_reduce"] += 1
    return buf


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format))


def _rotate(tensors, shift: int):
    """Each of ``tensors`` one hop around the ring: this rank sends to
    (rank + shift) mod D and receives from (rank - shift) mod D, all in one
    ``batch_isend_irecv``."""
    world, rank = dist.get_world_size(), dist.get_rank()
    dst, src = (rank + shift) % world, (rank - shift) % world
    sent = [_wire(t) for t in tensors]
    recv = [torch.empty_like(w) for w in sent]
    ops = [op for w, r in zip(sent, recv)
           for op in (dist.P2POp(dist.isend, w, dst), dist.P2POp(dist.irecv, r, src))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    collectives["ring"] += 1
    return [r.to(torch.bool) if t.dtype == torch.bool else r for t, r in zip(tensors, recv)]


class _Gather(torch.autograd.Function):
    """All-gather along dim 0, shard-major. Backward: the all-reduce of the
    cotangent, then this rank's slice (the sum of every rank's cotangent
    on it)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _all_gather(x)

    @staticmethod
    def backward(ctx, g):
        lo = dist.get_rank() * ctx.rows
        return _all_reduce(g)[lo : lo + ctx.rows]


class _RingRotate(torch.autograd.Function):
    """One hop of the ring over several tensors; backward rotates the
    cotangents the other way, back to the rank that owns each shard."""

    @staticmethod
    def forward(ctx, shift, *tensors):
        ctx.shift = shift
        ctx.float_in = [t.is_floating_point() for t in tensors]
        out = _rotate(tensors, shift)
        ctx.mark_non_differentiable(*[o for o, f in zip(out, ctx.float_in) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        back = iter(_rotate([g for g, f in zip(grads, ctx.float_in) if f], -ctx.shift))
        return (None, *[next(back) if f else None for f in ctx.float_in])


class DistCtx:
    """axis=None -> single-device semantics (gather = identity, psum =
    identity). Otherwise the default process group, which must be
    initialized: ``device_count()`` is its world size, ``shard_index()``
    this rank."""

    def __init__(self, axis: Optional[Any] = None):
        if isinstance(axis, str):
            axis = (axis,)
        self.axis: Optional[Tuple[str, ...]] = tuple(axis) if axis else None
        if self.axis is not None and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"DistCtx(axis={self.axis!r}) needs an initialized torch.distributed "
                f"process group (init_process_group) to run its collectives over"
            )

    @property
    def is_distributed(self) -> bool:
        """True whenever an axis is given, at world size 1 too (a one-device
        JAX mesh has an axis as well)."""
        return self.axis is not None

    def device_count(self) -> int:
        return dist.get_world_size() if self.axis else 1

    def shard_index(self) -> int:
        """This rank: the order ``gather`` concatenates the shards in."""
        return dist.get_rank() if self.axis else 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``x`` along dim 0, shard-major
        (differentiable; bool tensors travel as uint8)."""
        if not self.axis:
            return x
        return _Gather.apply(x)

    def ring_perm(self, shift: int = 1):
        """The (source, destination) pairs rotating the ring by ``shift``:
        rank i sends to (i + shift) mod D, one cycle over every rank."""
        d = self.device_count()
        return [(i, (i + shift) % d) for i in range(d)]

    def ring_rotate(self, x, shift: int = 1):
        """Rotate every leaf of ``x`` one hop around the ring: rank i
        receives rank (i - shift) mod D's value. Differentiable: the
        backward rotates each cotangent back to the rank that owns the
        shard. The identity without an axis and at world size 1."""
        if not self.axis or self.device_count() == 1:
            return x
        leaves = tree_leaves(x)
        return _replace_leaves(x, leaves, _RingRotate.apply(shift, *leaves))

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, as a new tensor (every rank
        passes a tensor of the same shape and dtype; bool travels as uint8;
        not differentiated). The identity without an axis."""
        if not self.axis:
            return x
        wire = torch.uint8 if x.dtype == torch.bool else x.dtype
        buf = x.to(wire, memory_format=torch.contiguous_format, copy=True)
        dist.broadcast(buf, src=src)
        collectives["broadcast"] += 1
        return buf.to(torch.bool) if x.dtype == torch.bool else buf

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (out of place; not differentiated: every
        caller reduces a detached statistic)."""
        if not self.axis:
            return x
        return _all_reduce(x)

    def psum_tree(self, tree):
        """Sum every leaf over the ranks: one all-reduce for each dtype and
        device, the leaves flattened into one buffer and split back."""
        if not self.axis:
            return tree
        leaves = tree_leaves(tree)
        groups = {}
        for i, t in enumerate(leaves):
            groups.setdefault((t.dtype, t.device), []).append(i)
        summed = list(leaves)
        for idx in groups.values():
            flat = _all_reduce_(torch.cat([leaves[i].detach().reshape(-1) for i in idx]))
            for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
                summed[i] = part.view_as(leaves[i])
        return _replace_leaves(tree, leaves, summed)


def check_rank_devices(ranks: int, device: str) -> None:
    """Raise SystemExit unless ``ranks`` ranks fit ``device``: one a GPU, or
    any number of CPU processes."""
    have = torch.cuda.device_count() if torch.device(device).type == "cuda" else ranks
    if have < ranks:
        raise SystemExit(f"--dp {ranks} needs >= {ranks} devices (have {have}; one rank "
                         f"runs on each GPU, or on the CPU with --device cpu)")


def spawn_ranks(fn: Callable[[Any, int], Any], args: Any, ranks: int, device: str,
                timeout: Optional[datetime.timedelta] = None) -> Any:
    """Run ``fn(args, rank)`` on ``ranks`` processes of one default process
    group and return rank 0's result. NCCL with rank r on ``cuda:r``, or,
    for a CPU ``device``, gloo ranks of one torch thread; ``timeout`` bounds
    each collective's wait (None: torch's default). Only rank 0 prints."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_rank_main, args=(fn, args, ranks, device, timeout, tmp),
                                    nprocs=ranks, join=True)
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def _rank_main(rank, fn, args, ranks, device, timeout, tmp):
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"), ranks),
                            rank=rank, world_size=ranks, timeout=timeout)
    try:
        with contextlib.ExitStack() as stack:
            if rank:        # rank 0 prints for the group
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            result = fn(args, rank)
        if rank == 0:
            torch.save(result, os.path.join(tmp, "result.pt"))
    finally:
        dist.destroy_process_group()
