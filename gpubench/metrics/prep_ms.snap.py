"""prep_ms.snap: receipt to preprocessed (prep pool wait and work), median."""
from gpubench.program_spans import prep_ms as read  # noqa: F401
