"""paged_attn_roofline.batch: kernel 2's share of its bound."""
from gpubench.layers import paged_attn_roofline as read  # noqa: F401
