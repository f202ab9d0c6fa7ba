"""K2, the lag correlations with the target row (``ops/kernels/lag_corr.py``):
(4, M, S + 1, buffer - 1) against J lags.

Operations and bytes of one hop as the problem needs them: each input
read once, each output written once (``count``); ``matches`` names the
kernel in a device trace."""

NAME = "lag_corr"

def matches(name: str) -> bool:
    return "lag_corr_kernel" in name


def count(d: dict, scenes: int) -> tuple[float, float]:
    m, s, j = d["num_mics"], d["num_srcs"], d["filter_length"]
    n2 = d["statistics_buffer_length"] - 1
    k2 = n2 - j + 1
    flops = 2 * 4 * m * (s + 1) ** 2 * j * k2
    nbytes = 4 * (4 * m * (s + 1) * n2 + 4 * (s + 1) ** 2 * j)
    return scenes * flops, scenes * nbytes
