"""Carry configurations, plans and states across from the JAX package.

The inputs are plain Python values and NumPy arrays (what
``dataclasses.asdict`` and ``np.asarray`` give for the JAX objects), so
this module imports nothing of JAX. Every array is checked against the
shape the port's config implies before it is moved to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apvast_torch import config as cfg_mod
from apvast_torch.engine.fd_hop import (
    COMPLEX_FIELDS,
    FdState,
    complex_dtype,
    fd_state_shapes,
)
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.engine.state import (
    ApVastState,
    SubspaceState,
    TrackingState,
    state_shapes,
    subspace_shapes,
)
from apvast_torch.utils.device import resolve_device, torch_dtype

_ENUM_FIELDS = {
    "toeplitz_variant": cfg_mod.ToeplitzVariant,
    "regularization": cfg_mod.RegularizationVariant,
    "weighting_norm": cfg_mod.WeightingNorm,
    "target_filter": cfg_mod.TargetFilterVariant,
    "threshold_method": cfg_mod.ThresholdMethod,
    "perceptual_frontend": cfg_mod.PerceptualFrontend,
    "gevd_solver": cfg_mod.GevdSolver,
}
_MATLAB = "MATLAB regularization, a later slice of the port"
# JAX config fields that no ported path reads yet: the values the port
# accepts for each (its JAX default), and the slice that brings it.
UNPORTED_FIELDS = {
    "bright_loading": ((1e-8,), _MATLAB),
    "dark_loading": ((5e-3,), _MATLAB),
}
# State fields of the JAX subspace solvers; None under GevdSolver.EIGH.
_SUBSPACE_STATE = ("gevd_q", "gevd_minv", "gevd_lam", "gevd_hop", "gevd_resid")


def config_from_jax(fields: dict) -> cfg_mod.ApVastConfig:
    """A port config from the field dict of a JAX ``ApVastConfig``
    (``dataclasses.asdict(jax_config)``). Enum members are matched by
    value; an unknown field raises ``ValueError``; a value of
    ``config.NOT_RUN``, or a field of :data:`UNPORTED_FIELDS` at another
    value than those it lists, raises ``NotImplementedError`` naming the
    slice that brings it."""
    known = {f.name for f in dataclasses.fields(cfg_mod.ApVastConfig)}
    unknown = set(fields) - known - set(UNPORTED_FIELDS)
    if unknown:
        raise ValueError(f"fields the port's config does not have: {sorted(unknown)}")
    cfg_mod.check_not_run(fields)
    kwargs = {}
    for name, value in fields.items():
        if name in UNPORTED_FIELDS:
            accepted, where = UNPORTED_FIELDS[name]
            if value not in accepted:
                raise NotImplementedError(
                    f"{name}={value!r} is read by {where}; the port "
                    f"takes it only at {accepted}"
                )
            continue
        if name in _ENUM_FIELDS:
            value = _ENUM_FIELDS[name](getattr(value, "value", value))
        elif name == "output_spans" and value is not None:
            value = tuple(int(x) for x in value)
        kwargs[name] = value
    return cfg_mod.ApVastConfig(**kwargs)


def _tensor(name, arr, shape, device, dtype):
    if arr is None:
        raise ValueError(f"{name} is required")
    arr = np.array(arr, order="C")
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape} != expected {tuple(shape)}")
    return torch.as_tensor(arr, device=device).to(dtype)


def plan_from_numpy(
    config: cfg_mod.ApVastConfig, arrays: dict, device=None
) -> ApVastPlan:
    """A port plan from the leaves of a JAX ``ApVastPlan`` as NumPy arrays
    (None for an absent leaf)."""
    device = resolve_device(device)
    dtype = torch_dtype(config)
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    m, s, j = config.num_mics, config.num_srcs, config.filter_length
    block, bins = config.block_size, config.num_bins
    nfb = config.fir_fft_size // 2 + 1
    shapes = {
        "window": ((block,), dtype),
        "rir_spec": ((2, m, s, nfb), cdtype),
        "target_rir_spec": ((2, m, nfb), cdtype),
        "target_filter_spec": ((2, s, bins), cdtype),
        "conv_kernels": ((2, 2 * m * s + m, config.rir_length), dtype),
        "dft_cos": ((block, bins), dtype),
        "dft_sin": ((block, bins), dtype),
        "idft_cos": ((bins, block), dtype),
        "idft_sin": ((bins, block), dtype),
        "idft_cos_plain": ((bins, block), dtype),
        "proj_idft_cos": ((bins, j), dtype),
        "proj_idft_sin": ((bins, j), dtype),
        "proj_dft_cos": ((j, bins), dtype),
        "proj_dft_sin": ((j, bins), dtype),
        "cfmr_sq": ((bins, None), dtype),
        "cs": ((), dtype),
        "ca": ((), dtype),
        "leff": ((), dtype),
        "spectrum_scale": ((), dtype),
    }
    unknown = set(arrays) - set(shapes)
    if unknown:
        raise ValueError(f"plan arrays the port does not have: {sorted(unknown)}")
    out = {}
    for name, (shape, dt) in shapes.items():
        arr = arrays.get(name)
        if arr is None:
            out[name] = None
            continue
        if name == "cfmr_sq":
            shape = (bins, np.shape(arr)[-1])
        out[name] = _tensor(name, arr, shape, device, dt)
    for name in ("window", "rir_spec", "target_rir_spec", "target_filter_spec",
                 "conv_kernels"):
        if out[name] is None:
            raise ValueError(f"plan array {name} is required")
    if config.use_matmul_dft and (out["dft_cos"] is None or out["proj_dft_cos"] is None):
        raise ValueError("use_matmul_dft needs the DFT and projection matrices")
    if config.perceptual and out["cfmr_sq"] is None:
        raise ValueError("perceptual weighting needs the perceptual tables")
    return ApVastPlan(**out)


def state_from_numpy(
    config: cfg_mod.ApVastConfig, arrays: dict, device=None
) -> ApVastState:
    """A port state from the leaves of a JAX ``ApVastState`` as NumPy arrays,
    e.g. to continue a stream part-way through. The subspace solver's
    carry (the ``gevd_*`` leaves its whitening has) is required, and a
    ``gevd_*`` leaf of another solver is refused."""
    device = resolve_device(device)
    dtype = torch_dtype(config)
    solver = subspace_shapes(config)
    for name in _SUBSPACE_STATE:
        if name not in solver and arrays.get(name) is not None:
            raise ValueError(f"state field {name} belongs to no solver of this config")
    shapes = state_shapes(config)
    unknown = set(arrays) - set(shapes) - set(_SUBSPACE_STATE)
    if unknown:
        raise ValueError(f"state arrays the port does not have: {sorted(unknown)}")
    carry = {}
    for name, shape in solver.items():
        if name == "gevd_hop":
            if arrays.get(name) is None:
                raise ValueError("gevd_hop is required")
            hop = np.asarray(arrays[name])
            if hop.shape != ():
                raise ValueError(f"gevd_hop: shape {hop.shape} != ()")
            carry[name] = int(hop)
        else:
            dt = torch.float32 if name == "gevd_resid" else dtype
            carry[name] = _tensor(name, arrays.get(name), shape, device, dt)
    data = {
        name: _tensor(name, arrays.get(name), shape, device, dtype)
        for name, shape in shapes.items()
    }
    if not carry:
        return ApVastState(**data)
    if "gevd_lam" in carry:
        return TrackingState(**data, **carry)
    return SubspaceState(**data, **({"gevd_minv": None} | carry))


def fd_state_from_numpy(config: cfg_mod.ApVastConfig, arrays: dict, device=None) -> FdState:
    """A port FD state from the leaves of a JAX ``FdState`` as NumPy arrays
    (None for an absent cross-frame history), e.g. to start both packages
    from one state or to continue a stream part-way through."""
    device = resolve_device(device)
    shapes = fd_state_shapes(config)
    unknown = set(arrays) - set(shapes)
    if unknown:
        raise ValueError(f"FD state arrays the port does not have: {sorted(unknown)}")
    fields = {}
    for name, shape in shapes.items():
        arr = arrays.get(name)
        if shape is None:
            if arr is not None:
                raise ValueError(f"{name} is carried only with fd_frame_taps > 1")
            fields[name] = None
            continue
        dt = complex_dtype(config) if name in COMPLEX_FIELDS else torch_dtype(config)
        fields[name] = _tensor(name, arr, shape, device, dt)
    return FdState(**fields)
