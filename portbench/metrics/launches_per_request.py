"""launches_per_request.serve: device kernels in the traced slice over its
requests, counted as `launches_per_step` counts them a step."""

from portbench.metrics.launches_per_step import read  # noqa: F401
