"""The device's idle share over the profiled hops: 1 - the union of its
operations' intervals over the host-clock time those hops take without
the profiler, i.e. the profiled slice's rebuild and plain hops each at
the mean of the window's unprofiled hops of their kind (the profiler
slows the host's graph launches, so the profiled hops' own host time
would overstate the idle)."""


def read(record: dict):
    prof = record.get("profile")
    if not prof or not prof["hops"]:
        return None
    kinds = {True: [], False: []}
    counted = {True: 0, False: 0}
    for s, flag, profiled in zip(record["hop_s"], record["rebuilt"], record["profiled"]):
        if profiled:
            counted[flag] += 1
        else:
            kinds[flag].append(s)
    host = 0.0
    for flag, n in counted.items():
        if n and not kinds[flag]:
            return None
        host += n * sum(kinds[flag]) / len(kinds[flag]) if n else 0.0
    return 1.0 - prof["busy_s"] / host
