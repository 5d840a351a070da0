"""Server-side decode-degeneration (repetition loop) detection.

The reference handles decode loops only *post hoc*: OutputCleaner truncates
and dedups repeated JSON objects (``output_cleaner.py:188-254``) and the
blog documents prompt fallbacks (``assets/blog.md:1028``). SURVEY.md's hard
part #5 calls for server-side detection: the scheduler checks each
sequence's tail after every decode chunk and stops sequences stuck in a
short periodic loop, freeing their slot and pages instead of burning the
full token budget.
"""

from __future__ import annotations

from typing import Optional, Sequence


def detect_repetition(
    tokens: Sequence[int],
    max_period: int = 64,
    min_repeats: int = 8,
    min_tail: int = 128,
) -> Optional[int]:
    """Return the period of a trailing token loop, or None.

    A loop is flagged when the last ``period * min_repeats`` tokens are
    exactly periodic with some period <= max_period. ``min_tail`` gates the
    check so short outputs (legitimate repetition, e.g. table rows) are
    never flagged.

    Cost: O(max_period * min_repeats) per call — negligible per chunk.
    """
    n = len(tokens)
    if n < max(min_tail, 2 * min_repeats):
        return None
    for period in range(1, max_period + 1):
        span = period * min_repeats
        if span > n:
            break
        tail = tokens[n - span:]
        pattern = tail[:period]
        if all(
            tail[i] == pattern[i % period] for i in range(span)
        ):
            # Require the pattern to be non-degenerate for period > 1
            # (otherwise period=1 catches it).
            if period == 1 or len(set(pattern)) > 1:
                return period
    return None
