"""flash_roofline_program.snap: kernel 1's share of its bound, from the program's spans."""
from gpubench.program_spans import flash_roofline_program as read  # noqa: F401
