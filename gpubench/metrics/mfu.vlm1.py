"""mfu.vlm1: the window's model FLOPs at the bf16 peak."""
from gpubench.layers import mfu as read  # noqa: F401
