"""mla_decode_roofline.vlm1: the paged latent kernel's share of its bound.

Each decode iteration launches the kernel (and its merge) once a layer; the
context tokens one launch reads are the program's count on the ``apply``
spans of the chunks dispatched inside the traced part (``kv_tokens`` over
their ``iterations``), its query rows the ``dispatch`` spans' ``rows``. The
bound of a launch is ``max(ops / 989 TFLOP/s, bytes / 3.35 TB/s)`` of
``arch.mla_decode_work``; the share is the traced launches' bounds over the
two kernels' device seconds. Silent where the program has no such kernel or
spans."""
from typing import Optional

from gpubench import work
from gpubench.program_spans import recorder, spans_in, traced_part

KERNELS = ("mla_latent_decode_kernel", "mla_latent_merge_kernel")


def read(run) -> Optional[float]:
    work_of = getattr(run.arch, "mla_decode_work", None)
    spans = spans_in(run)
    if work_of is None or spans is None:
        return None
    launches, _ = run.trace.by_name(KERNELS[0])
    _, device_s = run.trace.by_name(*KERNELS)
    a, b = traced_part(run)
    by_id = {s.id: s for s in recorder().spans()}
    tokens = rows = iterations = 0
    for s in spans:
        cause = by_id.get(s.parent)
        if (s.name == "apply" and "kv_tokens" in s.work and cause is not None
                and cause.name == "dispatch" and a <= cause.start_ns < b):
            tokens += s.work["kv_tokens"]
            rows += cause.work.get("rows", 0) * s.work["iterations"]
            iterations += s.work["iterations"]
    if launches == 0 or iterations == 0:
        return None
    ops, nbytes = work_of(tokens / iterations, rows / iterations, run.dims)
    return work.share(launches * work.bound_s(ops, nbytes), device_s)
