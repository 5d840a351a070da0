"""queue_ms.snap: EngineWorker.submit to admission, median."""
from gpubench.layers import queue_ms as read  # noqa: F401
