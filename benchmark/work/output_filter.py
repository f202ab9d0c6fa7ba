"""K5, output synthesis with the window and overlap-add fused
(``ops/kernels/output_filter.py``): (2, block) against (2, V S, J) filter
rows, tail (2, V S, block - hop).

Operations and bytes of one hop as the problem needs them: each input
read once, each output written once (``count``); ``matches`` names the
kernel in a device trace."""

NAME = "output_filter"

def matches(name: str) -> bool:
    return "output_filter_kernel<true>" in name


def count(d: dict, scenes: int) -> tuple[float, float]:
    v, s, j = d["num_eigenvectors"], d["num_srcs"], d["filter_length"]
    block, hop = d["block_size"], d["hop"]
    flops = 2 * 2 * v * s * j * block
    nbytes = 4 * (2 * block + 2 * v * s * j + block + 2 * 2 * v * s * (block - hop)
                  + 2 * v * s * hop)
    return scenes * flops, scenes * nbytes
