"""admit_overlap_share.snap: share of the traced part's admissions that the
engine made beside a decode chunk still on the device (``admit`` spans
whose note has ``beside``). Silent on a program without that admission
(no ``admits_beside_chunk`` counter) or without spans."""
from typing import Optional

from gpubench.program_spans import spans_in


def read(run) -> Optional[float]:
    if "admits_beside_chunk" not in run.counters1:
        return None
    admits = [s for s in spans_in(run) or () if s.name == "admit"]
    if not admits:
        return None
    return 100.0 * sum("beside" in s.work for s in admits) / len(admits)
