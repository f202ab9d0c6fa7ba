"""Stateful wrapper with the reference's calling convention (port of
``apvast_tpu/models/apvast.py::ApVast``): build once, then call
``process_input_buffers(hop_a, hop_b)`` per hop, ``process_signals`` for
whole signals, or ``process_hops_span`` to drain a backlog. On the card
the hop runs as a captured CUDA graph where the configuration allows
(``models/base.py``, ``engine/graph.py``), as the JAX package jit-compiles
it once."""

from __future__ import annotations

import numpy as np
import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.hop import process_hop
from apvast_torch.engine.plan import build_plan
from apvast_torch.engine.state import init_state
from apvast_torch.models.base import HopModel
from apvast_torch.observability import meter
from apvast_torch.utils.device import resolve_device

_meter = meter()


class ApVast(HopModel):
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
        graph: bool | None = None,
        **config_overrides,
    ):
        """Parameters mirror the reference constructor; extra keyword
        arguments flow into :class:`ApVastConfig`. Runs on ``"cuda"``
        unless ``device`` says otherwise (raises if no card is present).
        The initial response noise is injected (``response_noise``), drawn
        from ``generator``, or zero; a subspace solver's cold basis is
        injected (``subspace_init``, (2, jl, subspace_rank)) or drawn
        (``engine.state.init_state``). ``graph``: see
        :class:`apvast_torch.models.base.HopModel` (None: a CUDA graph on
        the card where the configuration allows; False: eager; True: a
        graph or ValueError)."""
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
        with _meter.setup_span("plan"):
            self.plan = build_plan(self.config, rir_a, rir_b, self.device)
        self._init_dispatch(graph)
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

    @property
    def _num_outputs(self) -> int:
        return self.config.num_solutions

    def _eager_hop(self, input_a, input_b):
        self._state, outputs = process_hop(
            self.config, self.plan, self._state, input_a, input_b
        )
        return outputs
