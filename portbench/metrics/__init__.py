"""One reader per metric: ``read(run)`` takes the run's data
(``harness.RunData``) and returns the metric's value, or None where the
run holds nothing to read, and the metric is then left out of the
result.  A file named after a metric serves it; otherwise the file named
after the metric's name before its first dot does (``idle_share.py``
reads ``idle_share.stream`` and ``idle_share.video``)."""
