"""The program's own hop meter (``apvast_torch.observability.meter()``)
over the run's timed window: its last ``len(hop_s)`` rows, which must
carry the record's ``profiled`` flags hop for hop. Every reader returns
None where the program has no meter, or the meter no such window."""

from __future__ import annotations


def program_meter():
    """The program's hop meter, or None if it has none."""
    try:
        from apvast_torch.observability import meter
    except ImportError:
        return None
    return meter()


def window(record: dict):
    """The meter's rows of the record's window, or None."""
    m = program_meter()
    if m is None:
        return None
    w = m.window(len(record["hop_s"]))
    if w is None or w.profiled != [bool(p) for p in record["profiled"]]:
        return None
    return w


def host_ms(record: dict, span: str):
    w = window(record)
    return None if w is None else w.host_ms(span)


def section_ms(record: dict, section: str):
    w = window(record)
    return None if w is None else w.section_ms(section)


def cause_share(record: dict, cause: str):
    w = window(record)
    return None if w is None else w.cause_share(cause)


def setup_s(name: str):
    m = program_meter()
    return None if m is None else m.setup_s(name)
