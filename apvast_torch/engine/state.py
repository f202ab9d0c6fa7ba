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

from apvast_torch.config import ApVastConfig, check_port_slice
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


def state_shapes(config: ApVastConfig) -> dict[str, tuple[int, ...]]:
    """Shape of every state tensor."""
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


def init_state(
    config: ApVastConfig,
    device: str | torch.device | None = None,
    response_noise: tuple[np.ndarray | torch.Tensor, np.ndarray | torch.Tensor]
    | None = None,
    generator: torch.Generator | None = None,
) -> ApVastState:
    """Fresh engine state on ``device`` (default ``"cuda"``).

    The reference seeds its response buffers with ``1e-3 * randn``. The
    JAX draws come from ``jax.random``, which torch cannot reproduce, so
    the noise is either injected as full-block arrays
    ``response_noise=(resp (4, m, s, block), target_resp (2, m, block))``,
    drawn from ``generator`` (scaled by ``noise_init_scale``), or zero
    when neither is given (the MATLAB behavior).
    """
    check_port_slice(config)
    device = resolve_device(device)
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
    shapes = state_shapes(config)
    zeros = {
        name: torch.zeros(shape, dtype=dtype, device=device)
        for name, shape in shapes.items()
        if name not in ("resp", "target_resp")
    }
    return ApVastState(
        resp=resp[..., config.hop :].contiguous(),
        target_resp=target_resp[..., config.hop :].contiguous(),
        **zeros,
    )
