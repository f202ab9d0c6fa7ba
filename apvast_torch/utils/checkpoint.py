"""Checkpoint and resume of a stream (port of
``apvast_tpu/utils/checkpoint.py``).

A checkpoint is the state's tensors in one ``.npz`` file in the JAX
package's layout, so files move between the two packages: one array per
field under its JAX name, None fields skipped, complex fields (the FD
engine's statistics) as a stacked (real, imaginary) pair under
``<name>__reim``. The tracking solver's host hop counter is written as an
int32 scalar and its residual as float32. A bfloat16 carry
(``tracking_li_bf16``) is written as NumPy writes the JAX package's, as
raw 2-byte records; :func:`load_state` reads those back as bfloat16, which
the JAX package's own ``load_state`` cannot. Resume is exact: a state
holds everything a hop reads.

Resuming a model: ``model.state = load_state(path, model.config,
device=model.device)``; a graphed model copies it into its static state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.fd_hop import FdState, fd_state_shapes
from apvast_torch.engine.state import ApVastState, state_shapes, subspace_shapes
from apvast_torch.utils.convert import fd_state_from_numpy, state_from_numpy

_REIM_SUFFIX = "__reim"
# The JAX state's solver fields, None where a configuration has no solver
# carry.
_SOLVER_FIELDS = ("gevd_q", "gevd_minv", "gevd_lam", "gevd_hop", "gevd_resid")


def _numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):  # the tracking solver's hop counter
        return np.asarray(leaf, dtype=np.int32)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.uint16).numpy().view("V2")
    return leaf.numpy()


def save_state(path: str, state) -> None:
    """Write the tensors of a state (any time-domain state, or an
    ``FdState``) to one ``.npz`` file, None fields skipped."""
    arrays = {}
    for f in dataclasses.fields(state):
        leaf = getattr(state, f.name)
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor) and leaf.is_complex():
            arrays[f.name + _REIM_SUFFIX] = _numpy(torch.stack([leaf.real, leaf.imag]))
        else:
            arrays[f.name] = _numpy(leaf)
    np.savez(path, **arrays)


def load_state(
    path: str,
    config: ApVastConfig,
    state_cls: type = ApVastState,
    device: str | torch.device | None = None,
):
    """Restore a state written by :func:`save_state` or by the JAX
    package's ``save_state`` on ``device`` (``"cuda"`` unless the caller
    asks for another). ``state_cls``: ``ApVastState`` for the time-domain
    engine (the solver's state class follows from ``config``), ``FdState``
    for the frequency-domain engine. Every field is checked against
    ``config``: a missing field or one of another shape raises ValueError
    naming it, as a mismatched configuration would corrupt the stream."""
    with np.load(path) as data:
        arrays = {}
        for name in data.files:
            if name.endswith(_REIM_SUFFIX):
                pair = data[name]
                arrays[name[: -len(_REIM_SUFFIX)]] = pair[0] + 1j * pair[1]
            else:
                arrays[name] = data[name]
    if state_cls is FdState:
        return fd_state_from_numpy(config, arrays, device)
    if not issubclass(state_cls, ApVastState):
        raise ValueError(f"state_cls must be ApVastState or FdState, got {state_cls}")
    return state_from_numpy(config, arrays, device)


def init_shapes(config: ApVastConfig, state_cls: type = ApVastState) -> dict:
    """The shape of every state field of ``config`` under its JAX name,
    None for a field that the configuration does not carry."""
    if state_cls is FdState:
        return fd_state_shapes(config)
    solver = subspace_shapes(config)
    return state_shapes(config) | {name: solver.get(name) for name in _SOLVER_FIELDS}
