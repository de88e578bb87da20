"""One reader per metric, `read(ctx)`, found by the metric's name (metrics/<name>.py).

A reader returns the metric's value, or None when its run has nothing to read
(the harness then leaves the metric out of the line). `common.py` holds the
arithmetic that several readers share."""
