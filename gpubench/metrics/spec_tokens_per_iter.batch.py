"""spec_tokens_per_iter.batch: tokens a verify slot-iteration emits."""
from gpubench.layers import spec_tokens_per_iter as read  # noqa: F401
