"""K1, the streaming RIR convolution (``ops/kernels/streaming_conv.py``):
segments (2, fir_fft_size) against (2, 2MS + M, rir_length) kernel rows,
hop outputs a row.

Operations and bytes of one hop as the problem needs them: each input
read once, each output written once (``count``); ``matches`` names the
kernel in a device trace."""

NAME = "streaming_conv"

def matches(name: str) -> bool:
    return "streaming_conv_kernel" in name


def count(d: dict, scenes: int) -> tuple[float, float]:
    rows = 2 * d["num_mics"] * d["num_srcs"] + d["num_mics"]
    taps, hop = d["rir_length"], d["hop"]
    flops = 2 * 2 * rows * taps * hop
    nbytes = 4 * (2 * d["fir_fft_size"] + 2 * rows * taps + 2 * rows * hop)
    return scenes * flops, scenes * nbytes
