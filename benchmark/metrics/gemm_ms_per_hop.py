"""Device ms a hop in cuBLAS's matrix products (kernels whose names say
gemm or gemv, and their split-K reductions): the matmul-DFT WOLA, the
perceptual weighting's products and the tracking solver's products."""

KEYS = ("gemm", "gemv", "splitkreduce")


def read(record: dict):
    prof = record.get("profile")
    if not prof or not prof["hops"]:
        return None
    total = sum(s for name, s in prof["kernels"].items()
                if any(k in name.lower() for k in KEYS))
    if total <= 0:
        return None
    return 1e3 * total / prof["hops"]
