"""preemptions.batch: requests preempted in the window."""
from gpubench.layers import preemptions as read  # noqa: F401
