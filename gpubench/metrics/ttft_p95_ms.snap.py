"""ttft_p95_ms.snap: due time to first token, 95th percentile, of the
requests due before the trace starts."""
from gpubench.layers import ttft_p95_host_part_ms as read  # noqa: F401
