"""Audio I/O and rate conversion for experiment drivers (port of
``apvast_tpu/utils/io.py``, on NumPy and SciPy): program material read as
float64 in [-1, 1], mono from the first channel, polyphase-resampled to
the processing rate; feeds written as 16-bit PCM."""

from __future__ import annotations

from math import gcd

import numpy as np


def load_wav(path: str, target_rate: float | None = None, gain: float = 1.0):
    """Read a WAV file -> (signal, rate): the first channel as float64,
    8-bit PCM centred at 128 and other integer PCM scaled by its maximum,
    times ``gain``, resampled to ``target_rate`` when given."""
    import scipy.io.wavfile
    import scipy.signal

    rate, data = scipy.io.wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    if data.dtype == np.uint8:
        data = (data.astype(np.float64) - 128.0) / 128.0
    elif np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float64) / float(np.iinfo(data.dtype).max)
    else:
        data = data.astype(np.float64)
    data = gain * data
    if target_rate is not None and target_rate != rate:
        g = gcd(int(target_rate), int(rate))
        data = scipy.signal.resample_poly(data, int(target_rate) // g, int(rate) // g)
        rate = int(target_rate)
    return data, rate


def save_wav(path: str, signal, rate: int) -> None:
    """Write float signals, clipped to [-1, 1], as 16-bit PCM."""
    import scipy.io.wavfile

    clipped = np.clip(np.asarray(signal), -1.0, 1.0)
    scipy.io.wavfile.write(path, int(rate), (clipped * 32767).astype(np.int16))
