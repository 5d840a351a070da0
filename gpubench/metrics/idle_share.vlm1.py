"""idle_share.vlm1: share of the traced part with nothing on the device."""
from gpubench.layers import idle_share as read  # noqa: F401
