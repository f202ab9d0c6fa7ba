"""Host-clock ms that a tracking rebuild hop (the dark matrices' Cholesky
and triangular inverse) takes beyond a plain hop: the mean of the
window's unprofiled rebuild hops minus that of its other unprofiled hops,
split by each hop's own ``rebuilt`` flag."""


def read(record: dict):
    plain, rebuild = [], []
    for s, flag, profiled in zip(record["hop_s"], record["rebuilt"], record["profiled"]):
        if not profiled:
            (rebuild if flag else plain).append(s)
    if not plain or not rebuild:
        return None
    return 1e3 * (sum(rebuild) / len(rebuild) - sum(plain) / len(plain))
