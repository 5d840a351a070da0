"""idle_admit_share.snap: device idle while the engine thread admits."""
from gpubench.program_spans import idle_admit_share as read  # noqa: F401
