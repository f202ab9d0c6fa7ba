"""Stateful wrapper with the reference's calling convention (port of
``apvast_tpu/models/apvast.py::ApVast``): build once, then call
``process_input_buffers(hop_a, hop_b)`` per hop, or ``process_signals``
for whole signals."""

from __future__ import annotations

import numpy as np
import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.hop import process_hop
from apvast_torch.engine.plan import build_plan
from apvast_torch.engine.state import init_state
from apvast_torch.engine.stream import run_stream, stitch_outputs
from apvast_torch.utils.device import resolve_device, torch_dtype


class ApVast:
    def __init__(
        self,
        block_size: int,
        rir_a: np.ndarray,
        rir_b: np.ndarray,
        filter_length: int,
        modeling_delay: int,
        reference_index_a: int,
        reference_index_b: int,
        number_of_eigenvectors: int,
        mu: float,
        statistics_buffer_length: int,
        hop_size: int | None = None,
        sampling_rate: int = 48000,
        run_a: bool = True,
        run_b: bool = True,
        perceptual: bool = True,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
        response_noise=None,
        subspace_init=None,
        **config_overrides,
    ):
        """Parameters mirror the reference constructor; extra keyword
        arguments flow into :class:`ApVastConfig`. Runs on ``"cuda"``
        unless ``device`` says otherwise (raises if no card is present).
        The initial response noise is injected (``response_noise``), drawn
        from ``generator``, or zero; a subspace solver's cold basis is
        injected (``subspace_init``, (2, jl, subspace_rank)) or drawn
        (``engine.state.init_state``)."""
        self.config = ApVastConfig.for_rirs(
            rir_a,
            rir_b,
            block_size=block_size,
            filter_length=filter_length,
            modeling_delay=modeling_delay,
            reference_index_a=reference_index_a,
            reference_index_b=reference_index_b,
            num_eigenvectors=number_of_eigenvectors,
            mu=mu,
            statistics_buffer_length=statistics_buffer_length,
            hop_size=hop_size,
            sampling_rate=sampling_rate,
            run_a=run_a,
            run_b=run_b,
            perceptual=perceptual,
            **config_overrides,
        )
        self.device = resolve_device(device)
        self.plan = build_plan(self.config, rir_a, rir_b, self.device)
        self.reset(
            generator=generator, response_noise=response_noise,
            subspace_init=subspace_init,
        )

    def reset(self, generator=None, response_noise=None, subspace_init=None) -> None:
        """Fresh state; ``silenced`` and ``rebuilds`` restart at 0."""
        self.state = init_state(
            self.config, self.device, response_noise=response_noise,
            generator=generator, subspace_init=subspace_init,
        )
        # Non-finite solver outputs summed over every hop since the reset
        # (an int32 tensor on the device, read without a sync until asked).
        self.silenced = torch.zeros((), dtype=torch.int32, device=self.device)
        # Hops on which the tracking solver refreshed its preconditioner or
        # the 'newton' solver rebuilt its carried inverse.
        self.rebuilds = 0

    def _signal(self, x) -> torch.Tensor:
        return torch.as_tensor(x).reshape(-1).to(
            device=self.device, dtype=torch_dtype(self.config)
        )

    def process_input_buffers(self, input_a, input_b):
        """One hop. Returns (out_a, out_b, out_a_t, out_b_t), each
        (V, hop, srcs) or None for a disabled zone."""
        hop = self.config.hop
        input_a, input_b = self._signal(input_a), self._signal(input_b)
        if input_a.shape[0] != hop or input_b.shape[0] != hop:
            raise ValueError(f"inputs must be exactly hop={hop} samples")
        self.state, outputs = process_hop(
            self.config, self.plan, self.state, input_a, input_b
        )
        self.silenced = self.silenced + outputs.silenced
        self.rebuilds += int(outputs.rebuilt)
        v = self.config.num_solutions
        return (
            outputs.out_a,
            outputs.out_b,
            outputs.out_a_t.expand(v, *outputs.out_a_t.shape),
            outputs.out_b_t.expand(v, *outputs.out_b_t.shape),
        )

    def process_signals(self, signal_a, signal_b):
        """All whole hops of two program signals. Returns stitched signals
        (V, T, srcs) per field (None for disabled zones)."""
        signal_a, signal_b = self._signal(signal_a), self._signal(signal_b)
        self.state, outs = run_stream(
            self.config, self.plan, self.state, signal_a, signal_b
        )
        self.silenced = self.silenced + outs.silenced.sum(dtype=torch.int32)
        self.rebuilds += int(outs.rebuilt.sum())
        v = self.config.num_solutions

        def stitch(x):
            return None if x is None else stitch_outputs(x)

        def stitch_target(t):  # (hops, hop, s) -> (v, T, s)
            flat = t.reshape(-1, t.shape[-1])
            return flat.expand(v, *flat.shape)

        return (
            stitch(outs.out_a),
            stitch(outs.out_b),
            stitch_target(outs.out_a_t),
            stitch_target(outs.out_b_t),
        )
