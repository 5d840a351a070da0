"""flash_roofline.snap: kernel 1's share of its bound."""
from gpubench.layers import flash_roofline as read  # noqa: F401
