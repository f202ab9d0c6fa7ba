"""K4, the Rayleigh-Ritz Jacobi eigensolver (``ops/kernels/jacobi_eigh.py``):
(2, k, k) at ``jacobi_sweeps`` sweeps, k the tracked subspace; each round
takes 6 operations per entry of A and 3 per entry of V, (npad - 1) rounds a
sweep, npad = k padded to 8.

Operations and bytes of one hop as the problem needs them: each input
read once, each output written once (``count``); ``matches`` names the
kernel in a device trace."""

NAME = "jacobi_eigh"

def matches(name: str) -> bool:
    for stem in ("jacobi_pair_kernel<", "jacobi_eigh_kernel<"):
        if stem in name:  # the third template argument is HERM (K7's form)
            return name.split(stem, 1)[1].split(",")[2].strip() == "false"
    return False


def count(d: dict, scenes: int) -> tuple[float, float]:
    k = d["subspace_rank"]
    npad = -(-k // 8) * 8
    flops = 2 * d["jacobi_sweeps"] * (npad - 1) * 9 * npad * npad
    nbytes = 4 * (2 * k * k + 2 * k * k + 2 * k)
    return scenes * flops, scenes * nbytes
