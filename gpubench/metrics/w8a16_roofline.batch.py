"""w8a16_roofline.batch: the W8A16 kernel's share of its bound."""
from gpubench.layers import w8a16_roofline as read  # noqa: F401
