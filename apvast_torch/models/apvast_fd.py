"""Stateful wrapper of the frequency-domain engine (port of
``apvast_tpu/models/apvast_fd.py::ApVastFD``)."""

from __future__ import annotations

import numpy as np
import torch

from apvast_torch.config import ApVastConfig
from apvast_torch.engine.fd_hop import init_fd_state, process_hop_fd
from apvast_torch.engine.plan import build_plan
from apvast_torch.models.base import HopModel
from apvast_torch.observability import meter
from apvast_torch.utils.device import resolve_device

_meter = meter()


class ApVastFD(HopModel):
    """Frequency-domain AP-VAST (see ``engine/fd_hop.py``).

    The constructor surface of :class:`apvast_torch.ApVast`, except that
    ``number_of_eigenvectors`` is the per-bin span rank (at most
    ``num_srcs * fd_frame_taps``), ``forgetting`` sets the covariance
    recursion's decay, and there is no statistics buffer (the config holds
    ``2 * filter_length + 1``, valid and unused). ``graph`` as for
    :class:`apvast_torch.ApVast`."""

    _fd = True

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
        hop_size: int | None = None,
        sampling_rate: int = 48000,
        run_a: bool = True,
        run_b: bool = True,
        perceptual: bool = True,
        forgetting: float = 0.9,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
        response_noise=None,
        graph: bool | None = None,
        **config_overrides,
    ):
        """Runs on ``"cuda"`` unless ``device`` says otherwise (raises if no
        card is present). The initial response noise is injected
        (``response_noise``), drawn from ``generator``, or zero."""
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
            statistics_buffer_length=2 * filter_length + 1,
            hop_size=hop_size,
            sampling_rate=sampling_rate,
            run_a=run_a,
            run_b=run_b,
            perceptual=perceptual,
            **config_overrides,
        )
        rank_cap = self.config.num_srcs * self.config.fd_frame_taps
        if number_of_eigenvectors > rank_cap:
            raise ValueError(
                "FD span rank (number_of_eigenvectors) must be <= "
                f"num_srcs * fd_frame_taps = {rank_cap}"
            )
        self.forgetting = float(forgetting)
        self.device = resolve_device(device)
        with _meter.setup_span("plan"):
            self.plan = build_plan(self.config, rir_a, rir_b, self.device)
        self._init_dispatch(graph)
        self.reset(generator=generator, response_noise=response_noise)

    def reset(self, generator=None, response_noise=None) -> None:
        """Fresh state; ``silenced`` restarts at 0 (``rebuilds`` stays 0:
        the FD engine has no rebuild)."""
        self.state = init_fd_state(
            self.config, self.device, response_noise=response_noise, generator=generator
        )
        # Non-finite per-bin filters silenced since the reset (an int32
        # tensor on the device, read without a sync until asked).
        self.silenced = torch.zeros((), dtype=torch.int32, device=self.device)
        self.rebuilds = 0

    @property
    def _num_outputs(self) -> int:
        return self.config.fd_num_solutions

    def _eager_hop(self, input_a, input_b):
        self._state, out = process_hop_fd(
            self.config, self.plan, self._state, input_a, input_b,
            forgetting=self.forgetting,
        )
        return out
