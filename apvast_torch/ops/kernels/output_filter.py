"""K5: circular filter bank + synthesis window + tail-form overlap-add;
K11: the same circular filter bank unfused.

Kernel: ``apvast_torch/csrc/output_filter.cu``. K5 replaces
``apvast_tpu/ops/pallas/output_filter.py::circular_filter_overlap_pallas``.
Bound on the H100: bytes (~15.7 MB of tail in, emit and new tail out at
the north-star shapes, against 0.26 GFLOP). One block per (zone, 32-row
tile, 128-sample tile) stages its filter rows and the circularly extended
input slice in shared memory and issues its tail loads before the loop;
each thread sums 8 rows x 4 consecutive samples over a sliding window of
the input, and the epilogue writes emit or new tail directly, so the full
(rows, block) synthesis tile never reaches device memory.

K11 replaces ``output_filter.py::circular_filter_pallas``, which nothing in
either package's engine calls: the template form of K5's kernel with the
window and the overlap-add switched off, writing the whole (rows, block)
output.

On the card both take up to :func:`max_taps` taps (the filter rows of a
32-row tile in shared memory) and raise ValueError past it.
"""

from __future__ import annotations

import torch

from apvast_torch.ops.kernels import _batch, _build

SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use


def max_taps(overlap: bool) -> int:
    """The most taps the card serves, 1632 for K5 and 1756 for K11: a
    block's shared memory (``smem_floats`` in the source) holds 32 filter
    rows and the input slice of 128 samples, taps padded to a multiple of
    4 (33 floats a tap), and for K5 the 32 x 128 tail tile."""
    floats = SMEM_LIMIT // 4 - 128 - (32 * 128 if overlap else 0)
    return floats // 33 // 4 * 4


def _check_taps(taps: int, overlap: bool) -> None:
    if taps > max_taps(overlap):
        raise ValueError(f"{taps} taps exceed the card's {max_taps(overlap)} (32 filter rows "
                         f"in a block's {SMEM_LIMIT} bytes of shared memory)")


def circular_filter_overlap_plain(
    windowed_input: torch.Tensor,
    filters: torch.Tensor,
    window: torch.Tensor,
    tail: torch.Tensor,
    hop: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``y = window * (filters circularly convolved with the input)``, then
    ``emit = y[:hop] + tail``-head and ``new_tail = y[hop:]`` + the tail's
    remainder (``ops.wola.wola_overlap_add_tail`` on y)."""
    block = windowed_input.shape[-1]
    taps = filters.shape[-1]
    ext = torch.cat(
        [windowed_input[:, block - (taps - 1) :], windowed_input], dim=-1
    )
    # windows[z, t, n] = ext[z, taps - 1 - t + n] = x[z, (n - t) mod block]
    windows = ext.unfold(-1, block, 1).flip(1)
    y = (filters @ windows) * window
    bh = block - hop
    v = y + torch.nn.functional.pad(tail, (0, block - bh))
    return v[..., :hop], v[..., hop:]


def circular_filter_overlap(
    windowed_input: torch.Tensor,
    filters: torch.Tensor,
    window: torch.Tensor,
    tail: torch.Tensor,
    hop: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Emit ``(zones, rows, hop)`` and new tail ``(zones, rows, block - hop)``
    of the filter rows ``filters`` (zones, rows, taps) applied to the
    analysis-windowed ``windowed_input`` (zones, block), with the synthesis
    ``window`` (block,) and the carried ``tail``. Same signature and
    layout as the JAX ``circular_filter_overlap_pallas``. Folded over
    scenes, every scene shares the one ``window``."""
    if _batch.via_op(windowed_input, filters, window, tail):
        return circular_filter_overlap_op(windowed_input, filters, window, tail, hop)
    _build.check_input(windowed_input, "windowed_input", 2)
    dev = windowed_input.device
    _build.check_input(filters, "filters", 3, dev)
    _build.check_input(window, "window", 1, dev)
    _build.check_input(tail, "tail", 3, dev)
    z, block = windowed_input.shape
    zf, rows, taps = filters.shape
    if zf != z or not 0 < taps <= block:
        raise ValueError(f"filters shape {tuple(filters.shape)} does not fit input")
    if not 0 < hop <= block:
        raise ValueError(f"hop={hop} outside (0, block={block}]")
    if tuple(window.shape) != (block,):
        raise ValueError(f"window shape {tuple(window.shape)} != ({block},)")
    if tuple(tail.shape) != (z, rows, block - hop):
        raise ValueError(f"tail shape {tuple(tail.shape)} != {(z, rows, block - hop)}")
    if dev.type == "cpu":
        return circular_filter_overlap_plain(windowed_input, filters, window, tail, hop)
    _check_taps(taps, True)
    emit = torch.empty((z, rows, hop), dtype=torch.float32, device=dev)
    new_tail = torch.empty((z, rows, block - hop), dtype=torch.float32, device=dev)
    _build.launch(
        "output_filter", "output_filter_launch",
        windowed_input, filters, window, tail, emit, new_tail,
        z, rows, taps, block, hop,
    )
    circular_filter_overlap.launches += 1
    return emit, new_tail


circular_filter_overlap.launches = 0


def circular_filter_plain(windowed_input: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """``irfft(rfft(windowed_input) * rfft(filters, n=block))``: the circular
    convolution of each zone's block with each of its filter rows."""
    block = windowed_input.shape[-1]
    spec = torch.fft.rfft(windowed_input, dim=-1)[:, None, :]
    return torch.fft.irfft(spec * torch.fft.rfft(filters, n=block, dim=-1), n=block, dim=-1)


def circular_filter(windowed_input: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """Circular convolution ``(zones, rows, block)`` of the analysis-windowed
    input blocks ``windowed_input`` (zones, block) with the filter rows
    ``filters`` (zones, rows, taps), taps <= block. Same signature and
    layout as the JAX ``circular_filter_pallas``."""
    _build.check_input(windowed_input, "windowed_input", 2)
    dev = windowed_input.device
    _build.check_input(filters, "filters", 3, dev)
    z, block = windowed_input.shape
    zf, rows, taps = filters.shape
    if zf != z or not 0 < taps <= block:
        raise ValueError(f"filters shape {tuple(filters.shape)} does not fit input")
    if dev.type == "cpu":
        return circular_filter_plain(windowed_input, filters)
    _check_taps(taps, False)
    out = torch.empty((z, rows, block), dtype=torch.float32, device=dev)
    _build.launch(
        "output_filter", "circular_filter_launch", windowed_input, filters, out,
        z, rows, taps, block,
    )
    circular_filter.launches += 1
    return out


circular_filter.launches = 0
circular_filter_overlap_op = _batch.fold(
    "circular_filter_overlap", circular_filter_overlap, shared=("window",),
    fake=lambda windowed_input, filters, window, tail, hop: (
        filters.new_empty((*filters.shape[:2], hop)), filters.new_empty(tail.shape)),
)
