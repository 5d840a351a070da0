"""moe_tokens_per_expert.vlm1: (token, expert) assignments that landed on a
held expert, per held expert, MoE layer and decode iteration: the program's
``moe_routed_here`` on the ``apply`` spans of the chunks dispatched inside
the traced part, over their ``iterations``. An even router gives rows x
top-k / routed experts (64 x 8 / 256 = 2). Silent where the program counts
no such thing."""
from typing import Optional

from gpubench.program_spans import recorder, spans_in, traced_part


def read(run) -> Optional[float]:
    spans = spans_in(run)
    if spans is None:
        return None
    a, b = traced_part(run)
    by_id = {s.id: s for s in recorder().spans()}
    here = iterations = 0
    for s in spans:
        cause = by_id.get(s.parent)
        if (s.name == "apply" and "moe_routed_here" in s.work and cause is not None
                and cause.name == "dispatch" and a <= cause.start_ns < b):
            here += s.work["moe_routed_here"]
            iterations += s.work["iterations"]
    if iterations == 0:
        return None
    c = run.dims["decoder"]
    layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return here / (iterations * layers * c["experts_held"][1])
