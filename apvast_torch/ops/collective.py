"""The one collective of a microphone-sharded hop: the sum of each rank's
partial statistics over the ranks that share a scene block (the
counterpart of the JAX package's ``jax.lax.psum`` over the mesh's mic
axis).

:func:`mic_sum` all-reduces through ``torch.distributed`` (gloo on the
CPU, and over CUDA tensors, where two ranks share one card). A
``torch.distributed`` call cannot take the tensors that ``torch.func.vmap``
batches, so the sum is also the op ``apvast_torch::mic_sum``, whose vmap
rule all-reduces the whole batched tensor at once: a scene-batched hop
makes one collective a hop for all of a rank's scenes, not one a scene.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# The process groups the op may name, by key (the op's schema takes a
# string, not a group object).
_GROUPS: dict[str, dist.ProcessGroup] = {}


def _key(group: dist.ProcessGroup) -> str:
    key = f"g{id(group)}"
    _GROUPS.setdefault(key, group)
    return key


def host_staged(group: dist.ProcessGroup) -> bool:
    """Whether collectives over ``group`` take host tensors: gloo's do
    (its CUDA forms copy through the host as well)."""
    return dist.get_backend(group) == "gloo"


@torch.library.custom_op("apvast_torch::mic_sum", mutates_args=())
def _mic_sum_op(x: torch.Tensor, group: str) -> torch.Tensor:
    pg = _GROUPS[group]
    out = x.to("cpu", copy=True) if host_staged(pg) else x.clone()
    out = out.contiguous()
    dist.all_reduce(torch.view_as_real(out) if out.is_complex() else out,
                    op=dist.ReduceOp.SUM, group=pg)
    return out.to(x.device)


@_mic_sum_op.register_fake
def _(x, group):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _mic_sum_vmap(info, in_dims, x, group):
    bdim = in_dims[0]
    if bdim is None:
        return _mic_sum_op(x, group), None
    return _mic_sum_op(x.movedim(bdim, 0), group), 0


_mic_sum_op.register_vmap(_mic_sum_vmap)


def mic_sum(x: torch.Tensor, group: dist.ProcessGroup | None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (every rank gets the sum;
    the reduction order is the backend's), or ``x`` itself for None."""
    if group is None:
        return x
    return _mic_sum_op(x, _key(group))
