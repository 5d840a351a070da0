"""engine_wait_ms.snap: preprocessed to the engine's submit (the worker's queue), median."""
from gpubench.program_spans import engine_wait_ms as read  # noqa: F401
