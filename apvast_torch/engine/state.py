"""The per-hop carry of the streaming engine (port of
``apvast_tpu/engine/state.py``).

Layout: batch axes lead (path, mic, src, rank), time is last. Path axis
order: 0 = A->A, 1 = A->B, 2 = B->A, 3 = B->B (signal -> destination
zone); a path's weighting zone is ``path % 2``. The hop returns a new
state and never writes into the tensors of the one it was given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apvast_torch.config import (
    ApVastConfig,
    check_port_slice,
    uses_subspace_solver,
    uses_tracking_solver,
)
from apvast_torch.utils.device import resolve_device, torch_dtype


@dataclasses.dataclass
class ApVastState:
    # Streaming-convolution input histories, (2, fir_history).
    conv_history: torch.Tensor
    # Loudspeaker / target response blocks in tail form (the first
    # block - hop samples), (4, m, s, block - hop) / (2, m, block - hop).
    resp: torch.Tensor
    target_resp: torch.Tensor
    # WOLA overlap accumulators in tail form, (4, m, s, block - hop) /
    # (2, m, block - hop).
    wresp_overlap: torch.Tensor
    wtarget_overlap: torch.Tensor
    # Statistics buffers: (4, m, s, stat_len - 1) in sample-J-deleted form
    # when config.carried_deleted_statistics, else (4, m, s, stat_len);
    # the target buffer is always raw, (2, m, stat_len).
    wresp_stat: torch.Tensor
    wtarget_stat: torch.Tensor
    # Sliding input blocks, (2, block).
    input_blocks: torch.Tensor
    # Output overlap accumulators, (2, v, s, block - hop) and
    # (2, s, block - hop), tail form.
    out_overlap: torch.Tensor
    target_out_overlap: torch.Tensor


@dataclasses.dataclass
class SubspaceState(ApVastState):
    """The state of a hop that runs a subspace GEVD solver: the data path
    plus the solver's carry (the JAX state's ``gevd_*`` leaves)."""

    # The warm-start basis (Ritz vectors), (2, jl, k).
    gevd_q: torch.Tensor
    # (2, jl, jl): the carried approximate inverse of the loaded dark matrix
    # under 'newton', its inverse Cholesky factor under 'tracking' (bfloat16
    # with tracking_li_bf16, see carry_dtypes); None under 'invert' and
    # 'solve'.
    gevd_minv: torch.Tensor | None


@dataclasses.dataclass
class TrackingState(SubspaceState):
    """The state of a hop that runs the tracking GEVD solver."""

    # Ritz values (2, k).
    gevd_lam: torch.Tensor
    # Hop counter of the rebuild cadence: a host int, so the cadence reads
    # nothing from the device.
    gevd_hop: int
    # The previous hop's relative Ritz residual, a float32 scalar.
    gevd_resid: torch.Tensor


def subspace_shapes(config: ApVastConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every subspace-solver state tensor of ``config`` (none for
    the exact solver)."""
    if not uses_subspace_solver(config):
        return {}
    jl, k = config.jl, config.subspace_rank
    shapes = {"gevd_q": (2, jl, k)}
    if config.subspace_whiten in ("newton", "tracking"):
        shapes["gevd_minv"] = (2, jl, jl)
    if uses_tracking_solver(config):
        shapes |= {"gevd_lam": (2, k), "gevd_hop": (), "gevd_resid": ()}
    return shapes


def carry_dtypes(config: ApVastConfig) -> dict[str, torch.dtype]:
    """The dtype of every subspace-solver state tensor of ``config`` that
    is not the config's: the residual (float32) and, with
    ``tracking_li_bf16``, the tracking solver's carried factor (bfloat16)."""
    dtypes = {"gevd_resid": torch.float32}
    if uses_tracking_solver(config) and config.tracking_li_bf16:
        dtypes["gevd_minv"] = torch.bfloat16
    return dtypes


def state_shapes(config: ApVastConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every state tensor of the hop's data path."""
    m, s, v = config.num_mics, config.num_srcs, config.num_solutions
    block, n, hop = config.block_size, config.statistics_buffer_length, config.hop
    return {
        "conv_history": (2, config.fir_history),
        "resp": (4, m, s, block - hop),
        "target_resp": (2, m, block - hop),
        "wresp_overlap": (4, m, s, block - hop),
        "wtarget_overlap": (2, m, block - hop),
        "wresp_stat": (4, m, s, n - 1 if config.carried_deleted_statistics else n),
        "wtarget_stat": (2, m, n),
        "input_blocks": (2, block),
        "out_overlap": (2, v, s, block - hop),
        "target_out_overlap": (2, s, block - hop),
    }


def response_tails(config: ApVastConfig, device: torch.device, response_noise=None,
                   generator: torch.Generator | None = None):
    """The initial response and target blocks of either engine in tail
    form, (4, m, s, block - hop) and (2, m, block - hop): the full-block
    noise ``response_noise`` injected, drawn from ``generator`` (scaled by
    ``noise_init_scale``), or zero (see :func:`init_state`)."""
    dtype = torch_dtype(config)
    m, s = config.num_mics, config.num_srcs
    block = config.block_size
    resp_shape = (4, m, s, block)
    tgt_shape = (2, m, block)
    if response_noise is not None:
        resp, target_resp = (
            torch.as_tensor(x, device=device).to(dtype) for x in response_noise
        )
        if tuple(resp.shape) != resp_shape or tuple(target_resp.shape) != tgt_shape:
            raise ValueError("response_noise shapes do not match config")
    elif generator is not None:
        scale = config.noise_init_scale
        gen_device = generator.device
        resp = scale * torch.randn(resp_shape, generator=generator, dtype=dtype,
                                   device=gen_device).to(device)
        target_resp = scale * torch.randn(tgt_shape, generator=generator,
                                          dtype=dtype, device=gen_device).to(device)
    else:
        resp = torch.zeros(resp_shape, dtype=dtype, device=device)
        target_resp = torch.zeros(tgt_shape, dtype=dtype, device=device)
    # Tail form: the head (first hop) is dropped by the first slide before
    # anything reads it.
    return (resp[..., config.hop :].contiguous(),
            target_resp[..., config.hop :].contiguous())


def init_state(
    config: ApVastConfig,
    device: str | torch.device | None = None,
    response_noise: tuple[np.ndarray | torch.Tensor, np.ndarray | torch.Tensor]
    | None = None,
    generator: torch.Generator | None = None,
    subspace_init: np.ndarray | torch.Tensor | None = None,
) -> ApVastState:
    """Fresh engine state on ``device`` (default ``"cuda"``).

    The reference seeds its response buffers with ``1e-3 * randn``. The
    JAX draws come from ``jax.random``, which torch cannot reproduce, so
    the noise is either injected as full-block arrays
    ``response_noise=(resp (4, m, s, block), target_resp (2, m, block))``,
    drawn from ``generator`` (scaled by ``noise_init_scale``), or zero
    when neither is given (the MATLAB behavior).

    A subspace solver's cold basis (2, jl, subspace_rank), a fixed
    full-rank random block in JAX (``jax.random.key(7)``), is likewise
    injected (``subspace_init``), drawn from ``generator`` after the noise,
    or drawn from a ``torch.Generator`` seeded with 7. The carried inverse
    of 'newton' and 'tracking' starts as the identity (bfloat16 under
    ``tracking_li_bf16``), so the first hop rebuilds it; the tracking
    solver's Ritz values start at zero and its hop counter at 0, inside
    the warmup window.
    """
    check_port_slice(config)
    device = resolve_device(device)
    dtype = torch_dtype(config)
    resp, target_resp = response_tails(config, device, response_noise, generator)
    shapes = state_shapes(config)
    zeros = {
        name: torch.zeros(shape, dtype=dtype, device=device)
        for name, shape in shapes.items()
        if name not in ("resp", "target_resp")
    }
    data = dict(resp=resp, target_resp=target_resp, **zeros)
    if not uses_subspace_solver(config):
        return ApVastState(**data)
    jl, k = config.jl, config.subspace_rank
    if subspace_init is not None:
        q = torch.as_tensor(subspace_init, device=device).to(dtype)
        if tuple(q.shape) != (2, jl, k):
            raise ValueError(
                f"subspace_init shape {tuple(q.shape)} != {(2, jl, k)}"
            )
    else:
        gen = generator or torch.Generator().manual_seed(7)
        q = torch.randn((2, jl, k), generator=gen, dtype=dtype,
                        device=gen.device).to(device)
    minv = None
    if "gevd_minv" in subspace_shapes(config):
        minv_dtype = carry_dtypes(config).get("gevd_minv", dtype)
        minv = torch.eye(jl, dtype=minv_dtype, device=device).repeat(2, 1, 1)
    if not uses_tracking_solver(config):
        return SubspaceState(**data, gevd_q=q.contiguous(), gevd_minv=minv)
    return TrackingState(
        **data,
        gevd_q=q.contiguous(),
        gevd_minv=minv,
        gevd_lam=torch.zeros((2, k), dtype=dtype, device=device),
        gevd_hop=0,
        gevd_resid=torch.zeros((), dtype=torch.float32, device=device),
    )
