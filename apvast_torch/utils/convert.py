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
from apvast_torch.engine.plan import ApVastPlan
from apvast_torch.engine.state import ApVastState, state_shapes
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
_SLICE_2 = "slice 2 of the port (the tracking subspace solver)"
_FD = "the frequency-domain engine, a later slice of the port"
_MATLAB = "MATLAB regularization, a later slice of the port"
# JAX config fields that no ported path reads yet: the values the port
# accepts for each, and the slice that brings it. The solver's knobs are
# accepted at their JAX default and at the value of JAX's
# production_overrides("tpu"); the JAX engine reads neither under
# GevdSolver.EIGH, this slice's solver.
UNPORTED_FIELDS = {
    "bright_loading": ((1e-8,), _MATLAB),
    "dark_loading": ((5e-3,), _MATLAB),
    "subspace_oversample": ((30, 14), _SLICE_2),
    "subspace_iters": ((3, 2), _SLICE_2),
    "subspace_orth": (("cholqr2",), _SLICE_2),
    "subspace_whiten": (("invert", "tracking"), _SLICE_2),
    "tracking_outer_steps": ((2, 1), _SLICE_2),
    "tracking_rebuild_period": ((4, 32), _SLICE_2),
    "tracking_warmup_hops": ((4, 6), _SLICE_2),
    "tracking_li_bf16": ((False,), _SLICE_2),
    "tracking_residual_precision": (("high",), _SLICE_2),
    "tracking_residual_rebuild": ((0.0, 2.5), _SLICE_2),
    "tracking_rr_basis": (("cholqr2", "direct"), _SLICE_2),
    "statistics_half_form": ((False, True), _SLICE_2),
    "small_eigh": (("lapack", "jacobi"), _SLICE_2),
    "jacobi_sweeps": ((4, 2), _SLICE_2),
    "use_pallas_subspace": ((False,), _SLICE_2),
    "use_pallas_whiten": ((False,), _SLICE_2),
    "fd_frame_taps": ((1,), _FD),
    "fd_bin_coupling": ((1,), _FD),
    "fd_eigh": (("lapack",), _FD),
    "fd_jacobi_sweeps": ((6,), _FD),
    "fd_span": (("all",), _FD),
    "fd_group_size": ((1,), _FD),
    "fd_coupled_iters": ((0,), _FD),
    "fd_coupled_relax": ((0.5,), _FD),
    "fd_coupled_method": (("cg",), _FD),
    "fd_group_rank_tol": ((0.0,), _FD),
    "fd_group_overlap": ((False,), _FD),
}
# Plan arrays the JAX package builds for paths the port does not run yet:
# the frequency-domain engine and the truncated weighting convolution.
_NOT_PORTED_PLAN = (
    "proj_idft_cos", "proj_idft_sin", "proj_dft_cos", "proj_dft_sin",
    "idft_cos_plain",
)
# State fields of the JAX subspace solvers; None under GevdSolver.EIGH.
_SUBSPACE_STATE = ("gevd_q", "gevd_minv", "gevd_lam", "gevd_hop", "gevd_resid")


def config_from_jax(fields: dict) -> cfg_mod.ApVastConfig:
    """A port config from the field dict of a JAX ``ApVastConfig``
    (``dataclasses.asdict(jax_config)``). Enum members are matched by
    value; an unknown field raises ``ValueError``, and a field of
    :data:`UNPORTED_FIELDS` at another value than those it lists raises
    ``NotImplementedError`` naming the slice that brings it."""
    known = {f.name for f in dataclasses.fields(cfg_mod.ApVastConfig)}
    unknown = set(fields) - known - set(UNPORTED_FIELDS)
    if unknown:
        raise ValueError(f"fields the port's config does not have: {sorted(unknown)}")
    kwargs = {}
    for name, value in fields.items():
        if name in UNPORTED_FIELDS:
            accepted, where = UNPORTED_FIELDS[name]
            if value not in accepted:
                raise NotImplementedError(
                    f"{name}={value!r} is read by {where}; this slice "
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
        "cfmr_sq": ((bins, None), dtype),
        "cs": ((), dtype),
        "ca": ((), dtype),
        "leff": ((), dtype),
        "spectrum_scale": ((), dtype),
    }
    unknown = set(arrays) - set(shapes) - set(_NOT_PORTED_PLAN)
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
    if config.use_matmul_dft and out["dft_cos"] is None:
        raise ValueError("use_matmul_dft needs the DFT matrices")
    if config.perceptual and out["cfmr_sq"] is None:
        raise ValueError("perceptual weighting needs the perceptual tables")
    return ApVastPlan(**out)


def state_from_numpy(
    config: cfg_mod.ApVastConfig, arrays: dict, device=None
) -> ApVastState:
    """A port state from the leaves of a JAX ``ApVastState`` as NumPy arrays,
    e.g. to continue a stream part-way through."""
    device = resolve_device(device)
    dtype = torch_dtype(config)
    for name in _SUBSPACE_STATE:
        if arrays.get(name) is not None:
            raise NotImplementedError(
                f"state field {name} belongs to the subspace solvers, "
                "slice 2 of the port"
            )
    shapes = state_shapes(config)
    unknown = set(arrays) - set(shapes) - set(_SUBSPACE_STATE)
    if unknown:
        raise ValueError(f"state arrays the port does not have: {sorted(unknown)}")
    return ApVastState(
        **{
            name: _tensor(name, arrays.get(name), shape, device, dtype)
            for name, shape in shapes.items()
        }
    )
