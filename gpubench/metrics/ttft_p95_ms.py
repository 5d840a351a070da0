"""ttft_p95_ms (end to end)."""
from gpubench.layers import ttft_p95_ms as read  # noqa: F401
