"""``realtime_x`` of the one live north-star stream (``ns16-prod-x1``), split from
the other cells' so that its wider spread between processes sets a bound
of its own: the same reading (``metrics/realtime_x.py``)."""

from harness.spec import metric_reader

read = metric_reader("realtime_x")
