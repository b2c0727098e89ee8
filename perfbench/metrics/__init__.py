"""One reader per metric, in a file named after the metric:
``read(run) -> float | None`` takes the number from a ``RunRecord``
(``perfbench/harness.py``) and returns None when the run has nothing to
read for it, and the harness then leaves the metric out."""
