"""dots.vlm1's architecture (``arch/dotsvlm1.py``) in the harness, on the CPU
at a tiny size (``data_vlm1/``: 3 decoder layers, 16 experts of which 4 are
held) through the program's EngineWorker: a sound closed-loop run comes out
correct, a planted fault and the control do not, the benchmark's copy of the
reference is the repository's, and the configuration's counts are pinned.

    python -m pytest gpubench/tests/test_dotsvlm1.py -q
"""

import os
import time
import types

import numpy as np
import pytest
import torch

import reference.dotsvlm1 as repo_reference
from gpubench import run

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_vlm1")
ARCH = run.load_arch("dotsvlm1")
TINY = run.load_json(os.path.join(DATA, "configs", "tiny-vlm1.json"))
FULL = run.load_json(os.path.join(run.ROOT, "gpubench", "configs", "dotsvlm1-bf16.json"))
SEED = 2**31 + 17


def tiny_run(seconds: float = 2.0, traced: bool = False, control=None) -> dict:
    torch.set_num_threads(2)
    cell = run.Cell("tiny-vlm1.page-reason", root=DATA, here=DATA)
    out = run.run_cell(cell, SEED, seconds, traced, "cpu", control=control)
    out.pop("record")
    return out


def test_a_sound_closed_loop_run_is_correct():
    out = tiny_run(traced=True)
    assert out["correct"], out["checked"]
    assert out["checked"]["served_gap"]["value"] <= 1e-4
    assert out["checked"]["prompt_len_gap"]["value"] == 0
    assert out["checked"]["token_count_gap"]["value"] == 0
    assert out["info"]["gap_tokens"] >= 4 and out["info"]["sampled_gap_tokens"] >= 4
    assert out["metrics"]["mfu.vlm1"]["value"] > 0
    counters = out["info"]["counters"]
    assert counters["graph_captures"] == 0 and counters["prefills"] >= 3


def test_the_control_is_not_correct():
    control = run.Cell("tiny-vlm1.page-reason", root=DATA, here=DATA).config["control"]
    assert control == FULL["control"] == {"QUANTIZE": "int8", "VISION_QUANTIZE": "int8"}
    out = tiny_run(control=control)
    assert not out["correct"]
    assert out["checked"]["served_gap_mean"]["value"] > out["checked"]["served_gap_mean"]["limit"]


def _drop_shared_expert(monkeypatch):
    from dots_ocr_tpu_torch.models import moe

    monkeypatch.setattr(moe, "swiglu", lambda x, *args, **kwargs: torch.zeros_like(x))


def _softmax_scale_without_mscale(monkeypatch):
    from dots_ocr_tpu_torch.models.config import DeepseekConfig

    monkeypatch.setattr(DeepseekConfig, "softmax_scale",
                        property(lambda self: self.qk_head_dim ** -0.5))


@pytest.mark.parametrize("fault", [_drop_shared_expert, _softmax_scale_without_mscale],
                         ids=["shared_expert_dropped", "mscale_left_out"])
def test_a_planted_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    out = tiny_run()
    assert not out["correct"]
    assert out["checked"]["served_gap"]["value"] > out["checked"]["served_gap"]["limit"]


PAD = TINY["model"]["special"]["imgpad_id"]


@pytest.mark.parametrize("served", [[5, 17, 300, 42], [PAD, 17, PAD, 42]])
def test_the_benchmarks_reference_is_the_repositorys(served):
    """The same gaps from both copies, also where a served token is the
    image pad id (a random model can draw it): it keeps its embedding."""
    dims = TINY["model"]
    w = ARCH.make_weights(dims, 5, "cpu", torch.float32, TINY["weights"])
    pixels = np.random.default_rng(3).integers(0, 256, (56, 84, 3), dtype=np.uint8)
    vision = repo_reference.page_tokens(w, dims, pixels)
    ids = ARCH.prompt_ids("read this", vision.shape[0], dims)
    logits = repo_reference.forward(w, dims, ids + served[:-1], vision)[len(ids) - 1:]
    want = logits.amax(1) - logits.gather(1, torch.tensor(served)[:, None])[:, 0]
    got = ARCH.served_gaps(w, dims, "none", pixels, "read this", served)
    assert torch.allclose(got, want, rtol=0, atol=1e-5), (got, want)
    x = torch.randn(9, dims["decoder"]["hidden_size"], generator=torch.Generator().manual_seed(1))
    assert torch.equal(ARCH.decoder_hidden(w["decoder"], dims, x),
                       repo_reference.decoder_hidden(w["decoder"], dims, x))


def test_the_published_configuration_counts():
    dims = FULL["model"]
    assert ARCH.kv_bytes_per_token(dims) == 576 * 2 * 7 == 8064
    assert run.page_bytes(run.Cell("vlm1.page-reason")) == 128 * 8064
    ops, nbytes = ARCH.mla_decode_work(3400, 64, dims)
    assert ops == 3400 * 128 * (576 + 512) * 2
    assert nbytes == 3400 * 576 * 2 + 64 * 128 * (576 + 512) * 2
    shapes = ARCH.decoder_shapes(dims)
    count = sum(int(np.prod(s)) for s in _leaves(shapes))
    # ~4.09B in the 7 layers, 1.85B in the untied vocabulary
    vocab = 2 * 129280 * 7168
    assert 4.0e9 < count - vocab - 7168 < 4.2e9
    d, heads = 7168, 128
    mla = d * 1536 + 1536 * heads * 192 + d * 576 + 512 * heads * 256 + heads * 128 * d
    expert = 3 * d * 2048
    # the shared expert and 8 x 8 / 256 of a routed one a token, the router
    assert ARCH.token_linear_params(dims) == (7 * mla + 3 * 3 * d * 18432
                                              + 4 * (d * 256 + expert * (1 + 8 * 8 / 256)))
    cfg = ARCH.program_config(dims)
    assert cfg.decoder.deepseek.experts_held == (0, 8)
    assert cfg.decoder.deepseek.n_routed_experts == 256 and cfg.decoder.num_layers == 7


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_the_span_readers_read_the_programs_counts():
    """mla_decode_roofline.vlm1 and moe_tokens_per_expert.vlm1 over the
    spans a tiny engine records under a (CPU) profiler, with a stand-in for
    the device trace."""
    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
    from dots_ocr_tpu_torch.utils.observability import SPANS
    from gpubench import record

    dims = TINY["model"]
    w = ARCH.make_weights(dims, 5, "cpu", torch.float32, TINY["weights"])
    engine = ContinuousBatchingEngine(
        ARCH.serve_params(w, dims, "none", "none"), ARCH.program_config(dims),
        torch.device("cpu"), sched=SchedulerConfig(num_pages=64, page_size=8, max_slots=4,
                                                   max_pages_per_seq=16, steps_per_sync=4))
    SPANS.clear()
    t0 = time.monotonic()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        engine.generate_batch(["one", "two pages", "three"], temperature=0.0, max_new_tokens=9)
    window = time.monotonic() - t0 + 1.0
    trace = types.SimpleNamespace(
        window_s=window, kernels=[],
        by_name=lambda *names: (40, 1e-3) if "mla_latent_decode_kernel" in names else (0, 0.0))
    rec = record.RunRecord(dims=dims, serving=TINY["serving"], mix={}, t0=t0, t1=t0 + window,
                           counters0={}, counters1=dict(engine.metrics), requests=[],
                           arch=ARCH, trace=trace, trace_edges=(t0 - 0.5, t0 + window))
    per_expert = run.reader("moe_tokens_per_expert.vlm1")(rec)
    roofline = run.reader("mla_decode_roofline.vlm1")(rec)
    applies = [s for s in SPANS.spans() if s.name == "apply"]
    assert applies and all("moe_routed_here" in s.work for s in applies)
    iterations = sum(s.work["iterations"] for s in applies)
    here = sum(s.work["moe_routed_here"] for s in applies)
    assert per_expert == pytest.approx(here / (iterations * 2 * 4))
    assert 0 < per_expert <= 3  # an expert takes a live row's token at most once
    assert roofline is not None and roofline > 0
    SPANS.clear()
