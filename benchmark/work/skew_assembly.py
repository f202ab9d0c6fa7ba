"""K3, the skew assembly of the half-form covariance
(``ops/kernels/skew_assembly.py``): lhsT (4, JS, 2M), rhs (4, 2M, SJ), c0
(4, S, SJ) into (4, SJ, SJ).

Operations and bytes of one hop as the problem needs them: each input
read once, each output written once (``count``); ``matches`` names the
kernel in a device trace."""

NAME = "skew_assembly"

def matches(name: str) -> bool:
    return "skew_assembly_kernel" in name


def count(d: dict, scenes: int) -> tuple[float, float]:
    m, s, j = d["num_mics"], d["num_srcs"], d["filter_length"]
    sj = s * j
    flops = 2 * 4 * sj * (2 * m) * sj
    nbytes = 4 * (4 * sj * 2 * m + 4 * 2 * m * sj + 4 * s * sj + 4 * sj * sj)
    return scenes * flops, scenes * nbytes
