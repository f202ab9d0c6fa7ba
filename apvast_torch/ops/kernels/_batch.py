"""How the kernel wrappers pass through ``torch.func.vmap``: the scene
axis of a batched hop (``apvast_torch/parallel/mesh.py``, the counterpart
of the JAX package's ``jax.vmap(process_hop)``) folded into each kernel's
own leading batch axis, so that a kernel launches once a hop for all
scenes.

A wrapper launches its kernel through ``ctypes``, which vmap cannot pass
through. So each wrapper on the hop's path is also registered as a
``torch.library.custom_op`` in the ``apvast_torch`` namespace (:func:`fold`),
whose body is the wrapper itself, with a fake function that gives its
output shapes and a ``register_vmap`` rule. A wrapper given a tensor that
vmap has batched (:func:`via_op`) calls its op; vmap then runs the rule,
which moves the scene axis of every operand to the front, reshapes
(N, B, ...) to (N * B, ...), calls the wrapper once on the folded
operands, and reshapes each output back to (N, B, ...). An operand that
vmap did not batch is expanded to every scene where the kernel reads it
per batch entry, and passed as it is where all scenes share it (K5's
synthesis window); a shared operand that vmap did batch raises. So the
launch counts of a batched hop are those of a single scene's hop, whatever
N is. No rule loops over scenes.
"""

from __future__ import annotations

import inspect

import torch
from torch._C._functorch import is_batchedtensor
from torch.utils._python_dispatch import _get_current_dispatch_mode

NAMESPACE = "apvast_torch"


def via_op(*args) -> bool:
    """Whether a wrapper calls its op: when any of ``args`` is a tensor that
    vmap has batched (the wrapper is being called inside
    ``torch.func.vmap``), or under a ``TorchDispatchMode`` whose
    ``sees_kernels`` is true (``observability.checked_hop``), which then
    sees each kernel as one op."""
    if getattr(_get_current_dispatch_mode(), "sees_kernels", False):
        return True
    return any(isinstance(a, torch.Tensor) and is_batchedtensor(a) for a in args)


def _fold(x: torch.Tensor, bdim: int | None, n: int) -> torch.Tensor:
    """(N, B, ...) -> (N * B, ...), contiguous; an unbatched operand is
    expanded to the N scenes first."""
    x = x.movedim(bdim, 0) if bdim is not None else x.expand(n, *x.shape)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(y: torch.Tensor, n: int) -> torch.Tensor:
    return y.reshape(n, y.shape[0] // n, *y.shape[1:])


def _fresh(out, args):
    """``out`` with every output that shares memory with an input or an
    earlier output cloned (an op may return no alias; a plain version may
    return views of one tensor, as K5's does)."""
    seen = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
    fresh = []
    for y in out if isinstance(out, tuple) else (out,):
        ptr = y.untyped_storage().data_ptr()
        if ptr in seen:
            y = y.clone()
            ptr = y.untyped_storage().data_ptr()
        seen.add(ptr)
        fresh.append(y)
    return tuple(fresh) if isinstance(out, tuple) else fresh[0]


def fold(name: str, wrapper, shared: tuple[str, ...] = (), fake=None):
    """Register ``wrapper`` (annotated: its schema is inferred from the
    annotations) as the op ``apvast_torch::<name>`` (its outputs cloned
    where they alias, :func:`_fresh`) with the fake function
    ``fake`` and the folding vmap rule of the module docstring. Every
    tensor argument is folded along its leading axis except those named in
    ``shared``, which must not be batched. Returns the op."""
    def impl(*args, **kwargs):
        return _fresh(wrapper(*args, **kwargs), args)

    schema = torch.library.infer_schema(wrapper, mutates_args=())
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", impl, mutates_args=(), schema=schema)
    if fake is not None:
        op.register_fake(fake)
    params = list(inspect.signature(wrapper).parameters)

    def rule(info, in_dims, *args, **kwargs):
        n = info.batch_size
        folded = []
        for param, arg, bdim in zip(params, args, in_dims):
            if not isinstance(arg, torch.Tensor):
                folded.append(arg)
            elif param in shared:
                if bdim is not None:
                    raise ValueError(f"{name}: {param} is shared by every scene; "
                                     "pass it unbatched (in_dims None)")
                folded.append(arg)
            else:
                folded.append(_fold(arg, bdim, n))
        out = op(*folded, **kwargs)
        if isinstance(out, tuple):
            return tuple(_unfold(y, n) for y in out), (0,) * len(out)
        return _unfold(out, n), 0

    op.register_vmap(rule)
    return op
