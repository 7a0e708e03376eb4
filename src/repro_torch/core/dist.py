"""Distribution context of the update builders (``repro.core.dist``), single
process only: ``gather``, ``psum`` and ``psum_tree`` are the identity.

Multi-device runs (``torch.distributed``: an all-gather with autograd, an
all-reduce, a ring of sends) are not yet ported; building a context with an
axis raises.
"""

from __future__ import annotations

from typing import Any, Optional


class DistCtx:
    """axis=None -> single-device semantics (gather = identity, psum = identity)."""

    def __init__(self, axis: Optional[Any] = None):
        if axis:
            raise NotImplementedError(
                f"DistCtx(axis={axis!r}): multi-device not yet ported to repro_torch"
            )
        self.axis = None

    @property
    def is_distributed(self) -> bool:
        return False

    def device_count(self) -> int:
        return 1

    def shard_index(self) -> int:
        return 0

    def gather(self, x):
        return x

    def psum(self, x):
        return x

    def psum_tree(self, tree):
        return tree
