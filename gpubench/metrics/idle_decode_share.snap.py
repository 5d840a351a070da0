"""idle_decode_share.snap: device idle while the engine thread is inside a decode chunk."""
from gpubench.program_spans import idle_decode_share as read  # noqa: F401
