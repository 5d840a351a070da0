"""tok_s (end to end)."""
from gpubench.layers import tok_s as read  # noqa: F401
