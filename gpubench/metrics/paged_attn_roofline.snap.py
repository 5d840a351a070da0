"""paged_attn_roofline.snap: kernel 2's share of its bound, from the program's count."""
from gpubench.program_spans import paged_attn_roofline as read  # noqa: F401
