"""A kernel's share of its roofline over the profiled hops: the least time
the card could take for the kernel's work (the larger of its operations
over the TF32 tensor-core peak and its bytes over the memory rate,
``benchmark/work/peaks.json``) over its device time, in %."""

from __future__ import annotations

from harness import spec


def kernel_seconds(record: dict, kernel: str) -> float:
    counter = spec.work_counter(kernel)
    return sum(s for name, s in record["profile"]["kernels"].items() if counter.matches(name))


def share(record: dict, kernel: str):
    prof = record.get("profile")
    if not prof or not prof["hops"]:
        return None
    measured = kernel_seconds(record, kernel)
    if measured <= 0:
        return None
    ops, nbytes = spec.work_counter(kernel).count(record["dims"], record["streams"])
    peaks = record["peaks"]
    bound = max(ops / peaks["operations_per_s"], nbytes / peaks["bytes_per_s"]) * prof["hops"]
    return 100.0 * bound / measured
