"""Named benchmark scenes (port of ``apvast_tpu/utils/scenes.py``).

The reference ships one scene (8 loudspeakers, 9 mics). The 16- and
32-loudspeaker 48 kHz scale scenes are generated deterministically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from apvast_torch.config import ApVastConfig
from apvast_torch.utils.rir import correlated_rirs, load_reference_rirs


@dataclasses.dataclass(frozen=True)
class Scene:
    name: str
    rir_a: np.ndarray
    rir_b: np.ndarray
    config: ApVastConfig


def reference_scene(rir_path: str | None = None, **overrides) -> Scene:
    """The measured-baseline scene (``rirs.mat`` at ``rir_path`` if given,
    else its synthetic stand-in) with the reference's fixture
    hyperparameters."""
    rir_a, rir_b = load_reference_rirs(rir_path)
    defaults = dict(
        block_size=1600,
        filter_length=100,
        modeling_delay=20,
        reference_index_a=7,
        reference_index_b=7,
        num_eigenvectors=50,
        mu=1.0,
        statistics_buffer_length=1000,
        sampling_rate=48000,
        perceptual=False,
        dtype="float32",
    )
    defaults.update(overrides)
    return Scene(
        "reference", rir_a, rir_b, ApVastConfig.for_rirs(rir_a, rir_b, **defaults)
    )


def scale_scene(num_srcs: int, num_mics: int | None = None, **overrides) -> Scene:
    """Synthetic 48 kHz scale scene: 2400-tap spatially correlated RIRs
    scaled by 1e-3 (the bundled scene's response level), J = 50 so that
    JL = 800 at 16 loudspeakers; M = S + 1 mics by default."""
    num_mics = num_mics or num_srcs + 1
    rir_len = 2400
    rir_a = 1e-3 * correlated_rirs(rir_len, num_srcs, num_mics, seed=101)
    rir_b = 1e-3 * correlated_rirs(rir_len, num_srcs, num_mics, seed=202)
    defaults = dict(
        block_size=1600,
        filter_length=50,
        modeling_delay=24,
        reference_index_a=0,
        reference_index_b=0,
        num_eigenvectors=50,
        mu=1.0,
        statistics_buffer_length=1000,
        sampling_rate=48000,
        perceptual=True,
        dtype="float32",
    )
    defaults.update(overrides)
    return Scene(
        f"scale{num_srcs}",
        rir_a,
        rir_b,
        ApVastConfig.for_rirs(rir_a, rir_b, **defaults),
    )
