"""The yardstick's arithmetic against hand counts and PERF.md's figures."""

import os

import pytest

from gpubench import work
from gpubench.run import ROOT, load_arch, load_json

DIMS = load_json(os.path.join(ROOT, "gpubench", "configs", "dotsocr-w8a16.json"))["model"]
ARCH = load_arch("dotsocr")


def test_kernel1_vision_case_is_168_gflop():
    # PERF.md's kernel 1 case: T = 6,656 packed (5,040 + 1,380 patches, -1 pad), 12 x 128
    ops, nbytes = work.flash_image_bound([5040, 1380], 6656, DIMS)
    assert ops == 4 * (5040**2 + 1380**2) * 12 * 128
    assert ops == pytest.approx(167.77e9, rel=1e-4)
    assert nbytes == 4 * 6656 * 1536 * 2 + 2 * 4 * 6656
    assert work.bound_s(ops, nbytes) == pytest.approx(ops / 989e12)


def test_causal_bound_counts_prefix_pairs():
    # one row of 3 valid queries at positions 4..6 sees 5 + 6 + 7 keys
    ops, _ = work.flash_causal_bound([(3, 7)], 4, 8, 12, DIMS)
    assert ops == 4 * (5 + 6 + 7) * 12 * 128


def test_kv_and_weight_bytes():
    assert ARCH.kv_bytes_per_token(DIMS) == 28672  # 2 KV heads x 128 x 2 B x K,V x 28 layers
    linears = ARCH.decoder_linear_shapes(DIMS)
    assert work.int8_decoder_bytes(DIMS, linears) == pytest.approx(1.545e9, rel=2e-3)  # ~1.55 GB
    assert ARCH.decoder_linear_params(DIMS) == 28 * (1536 * 1536 * 2 + 2 * 1536 * 256
                                                     + 3 * 1536 * 8960)
    assert ARCH.decoder_linear_params(DIMS) == 28 * sum(k * n for k, n in linears)


def test_flops_by_hand():
    c = DIMS["decoder"]
    n = ARCH.decoder_linear_params(DIMS)
    head = 2 * c["vocab_size"] * c["hidden_size"]
    assert ARCH.generated_flops(2, 201, DIMS) == (2 * n + head) * 2 + 4 * 1536 * 28 * 201
    assert ARCH.prompt_flops(1, DIMS) == 2 * n + 4 * 1536 * 28 + head
    embed, blocks, merger = ARCH.vision_linear_params(DIMS)
    assert embed == 588 * 1536 and merger == 6144 * 6144 + 6144 * 1536
    assert ARCH.vision_flops(4, DIMS) == 2 * (embed + blocks) * 4 + 2 * merger + 4 * 16 * 1536 * 42


def test_smart_resize_and_patches():
    assert work.smart_resize(1000, 800) == (1008, 812)
    h, w = work.smart_resize(2800, 2200)
    assert work.smart_resize(h, w) == (h, w)  # idempotent: the program's resize is a no-op
    assert work.smart_resize(5000, 4000)[0] * work.smart_resize(5000, 4000)[1] <= work.MAX_PIXELS
    assert work.page_patches(56, 84, DIMS) == (24, 6)


def test_interval_tokens_spreads_evenly():
    # 11 tokens over [0, 10]: 10 after the first, one a second; [2, 4] holds 2
    n, ctx = work.interval_tokens(0.0, 10.0, 11, 100, 2.0, 4.0)
    assert n == pytest.approx(2.0) and ctx == pytest.approx(2 * (101 + 3))
    assert work.interval_tokens(0.0, 10.0, 11, 100, 20.0, 30.0) == (0.0, 0.0)


def test_share_is_silent_without_a_measurement():
    assert work.share(1.0, 0.0) is None
    assert work.share(1.0, 4.0) == 25.0


def test_context_sum_of_decoding_requests():
    from gpubench.loadgen import RequestSpec
    from gpubench.record import Request, RunRecord

    spec = RequestSpec(0, 56, 56, 11, 0.0, 1.0, 0, 16, 4)
    # 11 tokens over [0, 10] after a 100-token prompt: context 101 + t
    r = Request(spec=spec, due=0.0, first_token_at=0.0, finished_at=10.0, prompt_len=100,
                tokens=list(range(11)))
    run = RunRecord(DIMS, {}, {}, 0.0, 10.0, {}, {}, [r, r], ARCH)
    # averaged over [2, 4]: 2 x (101 + 3)
    assert run.context_sum(2.0, 4.0) == pytest.approx(2 * 104.0)
    assert run.context_sum(20.0, 30.0) == 0.0


def test_kernel_names_are_shortened_for_the_breakdown():
    from gpubench.trace import short

    assert short("void (anonymous namespace)::flash_fwd_kernel<128>(unsigned short const*, int)"
                 ) == "flash_fwd_kernel"
    assert short("void w8a16::w8a16_kernel<(w8a16::Split)0>(w8a16::Args)") == "w8a16::w8a16_kernel"
    assert short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert short("at::native::vectorized_elementwise_kernel<4, at::native::Fn>(int)"
                 ) == "at::native::vectorized_elementwise_kernel"


def test_host_clock_metrics_read_the_window_before_the_trace():
    # a traced run reads its trace inside the window, which holds the host up:
    # queue time and MFU read the window's part before the trace starts
    from gpubench import layers
    from gpubench.loadgen import Traffic
    from gpubench.record import Request, RunRecord

    mix = load_json(os.path.join(ROOT, "gpubench", "traffic", "snap-ocr.json"))
    spec = Traffic(mix, 1, DIMS).request(0)
    reqs = []
    for due, queued in ((1.0, 0.1), (2.0, 0.3), (8.0, 4.0)):
        r = Request(spec=spec, due=due, sent=due)
        r.admitted_at = r.first_token_at = due + queued
        r.finished_at, r.prompt_len, r.tokens = due + queued + 1.0, 100, [1] * 10
        reqs.append(r)
    rec = RunRecord(dims=DIMS, serving={}, mix=mix, t0=0.0, t1=10.0, counters0={},
                    counters1={}, requests=reqs, arch=ARCH)
    assert layers.queue_ms(rec) == pytest.approx(300.0)
    whole = layers.mfu(rec)
    rec.trace_edges = (5.0, 7.0)
    assert rec.host_part() == (0.0, 5.0)
    assert layers.queue_ms(rec) == pytest.approx(200.0)
    assert layers.mfu(rec) == pytest.approx(
        100.0 * rec.model_flops(0.0, 5.0) / 5.0 / work.PEAK_OPS_PER_S["bf16"])
    assert layers.mfu(rec) != pytest.approx(whole)
