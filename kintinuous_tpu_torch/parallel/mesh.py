"""The slab mesh: the port's stand-in for the JAX package's
`jax.sharding.Mesh` on axis "z" and the collectives its sharded steps
call inside `shard_map` (`psum`, `pmin`, the ring `ppermute`).

A SlabMesh is an ordered list of torch devices, one per slab; the list
may name one device more than once, which places several slabs on one
card (or on the CPU), as the JAX tests place their mesh on virtual CPU
devices. Slab i holds z-slab i of the volume and pixel-row block i of
each image.

One host thread issues every slab's work in turn (slab 0 first): there
is no collective in flight between devices, so a collective here is a
plain function over one tensor per slab. Transfers are
`Tensor.to(dev, non_blocking=True)`, which returns the tensor itself
when it is already on `dev`, so slabs that share a device share their
replicated values at no cost.

Replicated state (pose, wrap, origin, predictions, the RGB-D pyramid)
lives once, on the mesh's first device (`home`); a slab's work takes
its own copy with `replicate` or `to_slab`. `psum` and `pmin` sum or
take the minimum on `home`, in slab order, and return one copy per slab
on that slab's device, as the JAX collectives replicate their result.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

DeviceLike = Union[str, torch.device]


class SlabMesh:
    """An ordered list of devices, one per z-slab (repeats allowed)."""

    def __init__(self, devices: Sequence[DeviceLike]):
        if not devices:
            raise ValueError("a slab mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.n = len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where replicated state lives: the first slab's device."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"SlabMesh({[str(d) for d in self.devices]})"

    # ---------------------------------------------------------- placement
    def to_slab(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return x.to(self.devices[i], non_blocking=True)

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """One copy of x per slab, on that slab's device."""
        return [x.to(d, non_blocking=True) for d in self.devices]

    def to_home(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [x.to(self.home, non_blocking=True) for x in xs]

    # -------------------------------------------------------- collectives
    def psum_home(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over the slabs' tensors, on `home` (slab order)."""
        total = xs[0].to(self.home, non_blocking=True)
        for x in xs[1:]:
            total = total + x.to(self.home, non_blocking=True)
        return total

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """jax.lax.psum: the sum, replicated on every slab's device."""
        return self.replicate(self.psum_home(xs))

    def pmin(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """jax.lax.pmin: the elementwise minimum, replicated."""
        low = xs[0].to(self.home, non_blocking=True)
        for x in xs[1:]:
            low = torch.minimum(low, x.to(self.home, non_blocking=True))
        return self.replicate(low)

    def ppermute_from_next(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ring ppermute perm=[(i, (i-1) % n)]: slab i receives slab
        (i+1) % n's tensor, on slab i's device."""
        return [xs[(i + 1) % self.n].to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]

    def ppermute_from_prev(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The ring ppermute perm=[(i, (i+1) % n)]: slab i receives slab
        (i-1) % n's tensor, on slab i's device."""
        return [xs[(i - 1) % self.n].to(d, non_blocking=True)
                for i, d in enumerate(self.devices)]
