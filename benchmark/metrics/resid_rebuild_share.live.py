"""``resid_rebuild_share`` of the one live north-star stream (``ns16-prod-x1``),
split from the other cells' as it moves ``realtime_x.live``: the same reading
(``metrics/resid_rebuild_share.py``)."""

from harness.spec import metric_reader

read = metric_reader("resid_rebuild_share")
