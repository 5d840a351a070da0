"""dots.vlm1 (DeepSeek-V3's decoder behind dots.ocr's encoder) on the port,
against the plain float32 reference ``reference/dotsvlm1.py``, at a tiny
size on the CPU with seeded random weights in float32.

Every tolerance below is float32 arithmetic summed in another order (the
program's expanded prefill through one library attention call, its absorbed
decode through the latent kernel's plain version, its grouped expert
products) against the reference's blocks: about 1e-6 relative on logits of
magnitude ~10, so 1e-4 absolute leaves a margin of ten and catches any
missing term (a dropped expert or a wrong rope scale moves logits by 1e-2
or more).
"""

import math

import numpy as np
import pytest
import torch
from PIL import Image

import reference.dotsvlm1 as ref
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models import moe as program_moe
from dots_ocr_tpu_torch.models.config import YarnRope
from dots_ocr_tpu_torch.models.rope import yarn_inv_freq, yarn_rope_table
from dots_ocr_tpu_torch.models.vlm import vlm_prefill
from dots_ocr_tpu_torch.ops.mla_attention import mla_decode_reference, mla_paged_decode
from gpubench import run

ARCH = run.load_arch("dotsvlm1")
TOL = 1e-4

VISION = {"hidden_size": 32, "num_layers": 2, "num_heads": 2, "head_dim": 16,
          "intermediate_size": 64, "patch_size": 14, "temporal_patch_size": 1,
          "spatial_merge_size": 2, "in_channels": 3, "rms_norm_eps": 1e-05,
          "rope_theta": 10000.0, "post_norm": True, "qkv_bias": True, "window_size": 0,
          "full_attn_layers": [], "image_mean": [0.48145466, 0.4578275, 0.40821073],
          "image_std": [0.26862954, 0.26130258, 0.27577711]}
YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1, "mscale_all_dim": 1,
        "original_max_position_embeddings": 64, "type": "yarn"}


def tiny_dims(held=(4, 4)) -> dict:
    """DeepSeek-V3's decoder at a tiny size: 1 dense layer then 2 MoE layers
    of 16 experts in 4 groups (top-4 of the best 2 groups), this device
    holding ``held`` (first, count)."""
    decoder = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 3,
               "num_attention_heads": 4, "num_key_value_heads": 4, "intermediate_size": 96,
               "rms_norm_eps": 1e-06, "rope_theta": 10000, "attention_bias": False,
               "tie_word_embeddings": False, "max_position_embeddings": 163840,
               "q_lora_rank": 32, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
               "qk_rope_head_dim": 8, "v_head_dim": 16, "first_k_dense_replace": 1,
               "moe_intermediate_size": 32, "n_routed_experts": 16, "experts_held": list(held),
               "num_experts_per_tok": 4, "n_group": 4, "topk_group": 2,
               "routed_scaling_factor": 2.5, "norm_topk_prob": True, "n_shared_experts": 1,
               "rope_scaling": dict(YARN)}
    special = {"eos_token_id": 511, "pad_token_id": 0, "im_start_id": 510, "im_end_id": 511,
               "img_id": 507, "imgpad_id": 508, "endofimg_id": 509}
    return {"vision": VISION, "decoder": decoder, "special": special, "dtype": "float32"}


DIMS = tiny_dims()
INIT = {"std": 0.1, "final_norm_gain": 4.0}


@pytest.fixture(scope="module")
def weights():
    return ARCH.make_weights(DIMS, 7, "cpu", torch.float32, INIT)


def page(seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (56, 84, 3), np.uint8)


@pytest.mark.parametrize("with_page", [True, False])
def test_prefill_logits_match_the_reference(weights, with_page):
    cfg = ARCH.program_config(DIMS)
    params = ARCH.serve_params(weights, DIMS, "none", "none")
    vision = ref.page_tokens(weights, DIMS, page()) if with_page else None
    n_vis = 0 if vision is None else vision.shape[0]
    ids = ([507] + [508] * n_vis + [509] if with_page else []) + list(range(30, 70))
    want = ref.forward(weights, DIMS, ids, vision)
    x = torch.tensor([ids])
    if with_page:
        # the program's own splice of the same vision tokens
        from dots_ocr_tpu_torch.models.decoder import decoder_prefill, logits_from_hidden
        from dots_ocr_tpu_torch.models.vlm import splice_vision_embeddings

        embeds = splice_vision_embeddings(
            params["decoder"]["embed"][x], vision,
            torch.zeros(n_vis, dtype=torch.int64), torch.arange(1, n_vis + 1))
        hidden, _ = decoder_prefill(params["decoder"], cfg.decoder, embeds,
                                    torch.arange(len(ids))[None], torch.tensor([len(ids)]))
        got = logits_from_hidden(params["decoder"], cfg.decoder, hidden)[0]
    else:
        got, _ = vlm_prefill(params, cfg, x, torch.arange(len(ids))[None],
                             torch.tensor([len(ids)]))
        got = got[0]
    assert float((got - want).abs().max()) <= TOL


def _serve(weights, page_size: int, chunk: int, prompts, with_pages):
    cfg = ARCH.program_config(DIMS)
    engine = ContinuousBatchingEngine(
        ARCH.serve_params(weights, DIMS, "none", "none"), cfg, torch.device("cpu"),
        sched=SchedulerConfig(num_pages=128, page_size=page_size, max_slots=4,
                              max_pages_per_seq=32, steps_per_sync=4,
                              prefill_chunk_tokens=chunk))
    ids = [engine.submit(p, images=[Image.fromarray(page(i))] if with_pages[i] else [],
                         temperature=0.0, max_new_tokens=20, logprobs=True)
           for i, p in enumerate(prompts)]
    engine.run()
    return engine, [engine.finished_request(r) for r in ids]


@pytest.mark.parametrize("page_size,chunk", [(8, 0), (8, 16)])
def test_paged_decode_matches_the_full_forward(weights, page_size, chunk):
    """Prefill, then decode through ContinuousBatchingEngine over the latent
    pages (across page boundaries; with ``chunk`` the long prompt's later
    chunks read the earlier ones from the pages): each served token is the
    reference's best, and its log-probability (a function of every logit)
    is the reference's."""
    prompts = ["hi", "a longer prompt that goes past a chunk of sixteen tokens"]
    with_pages = [True, False]
    engine, reqs = _serve(weights, page_size, chunk, prompts, with_pages)
    assert all(len(r.prompt_ids) + len(r.output_ids) > 3 * page_size for r in reqs)
    if chunk:
        assert engine.metrics["prefill_chunks"] >= 3
    for i, r in enumerate(reqs):
        vision = ref.page_tokens(weights, DIMS, page(i)) if with_pages[i] else None
        logits = ref.forward(weights, DIMS, r.prompt_ids + r.output_ids[:-1],
                             vision)[len(r.prompt_ids) - 1:]
        served = torch.tensor(r.output_ids)[:, None]
        gaps = logits.amax(1) - logits.gather(1, served)[:, 0]
        lp = torch.log_softmax(logits, -1).gather(1, served)[:, 0]
        assert len(r.output_ids) == 20
        assert float(gaps.max()) <= TOL
        assert float((lp - torch.tensor(r.output_logprobs)).abs().max()) <= TOL
    assert engine.metrics["moe_routed_here"] > 0
    assert engine.metrics["kv_tokens_read"] > 0


@pytest.mark.parametrize("count", [2, 4, 8])
def test_the_ranks_shares_add_up_to_the_uncut_layer(weights, count):
    """Every held-expert set of a (16 / count)-way split computes its part;
    with the shared expert counted once, the parts add up to the reference's
    layer over all 16 experts."""
    c_full = tiny_dims((0, 16))["decoder"]
    m = {k: w[0] for k, w in weights["decoder"]["moe"].items()}
    s = {k: w[0] for k, w in weights["decoder"]["shared"].items()}
    full = {**m, **{k: torch.randn(16, *m[k].shape[1:], generator=torch.Generator().manual_seed(i))
                    * 0.1 for i, k in enumerate(("gate", "up", "down"))}}
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(3))
    want = ref.moe(x, full, s, c_full)
    shared = ref.swiglu(x, s["gate"], s["up"], s["down"])
    total = shared.clone()
    for first in range(0, 16, count):
        ds = ARCH.program_config(tiny_dims((first, count))).decoder.deepseek
        part = {**full, **{k: full[k][first:first + count] for k in ("gate", "up", "down")}}
        total += program_moe.moe_block(x, part, s, ds) - shared
    assert float((total - want).abs().max()) <= TOL


def _noaux_formula(scores: np.ndarray, bias: np.ndarray, n_group: int, topk_group: int,
                   top_k: int, scale: float):
    """DeepSeek-V3's noaux_tc written out a token at a time, ties to the
    lower index: groups by the sum of their two best biased scores, the best
    topk_group groups kept, the others' experts at 0, the top_k experts."""
    ids, weights = [], []
    per = scores.shape[1] // n_group
    for s in scores:
        choice = s + bias
        groups = [sorted(choice[g * per:(g + 1) * per], reverse=True)[:2] for g in range(n_group)]
        group_score = [a + b for a, b in groups]
        kept = sorted(range(n_group), key=lambda g: (-group_score[g], g))[:topk_group]
        masked = [choice[e] if e // per in kept else 0.0 for e in range(len(s))]
        top = sorted(range(len(s)), key=lambda e: (-masked[e], e))[:top_k]
        w = np.array([s[e] for e in top])
        ids.append(top)
        weights.append(w / (w.sum() + 1e-20) * scale)
    return np.array(ids), np.array(weights)


@pytest.mark.parametrize("case", ["random", "groups_tie", "experts_tie"])
def test_noaux_tc_choice_matches_the_formula(case):
    rng = np.random.RandomState(5)
    logits = rng.randn(12, 16).astype(np.float32)
    bias = (rng.randn(16) * 0.1).astype(np.float32)
    if case == "groups_tie":  # groups 0 and 3 score the same; 1 and 2 too
        logits[:, 12:16] = logits[:, 0:4]
        logits[:, 8:12] = logits[:, 4:8]
        bias[12:16], bias[8:12] = bias[0:4], bias[4:8]
    elif case == "experts_tie":  # equal experts within and across kept groups
        logits[:, 1] = logits[:, 0]
        logits[:, 5] = logits[:, 0]
        bias[1] = bias[5] = bias[0]
    ds = ARCH.program_config(DIMS).decoder.deepseek
    # the router is the identity, so the float32 router's logits are ``logits``
    idx, w = program_moe.route_noaux_tc(torch.from_numpy(logits), torch.eye(16),
                                        torch.from_numpy(bias), ds)
    scores = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    want_idx, want_w = _noaux_formula(scores.astype(np.float32), bias, 4, 2, 4, 2.5)
    assert idx.tolist() == want_idx.tolist()
    np.testing.assert_allclose(w.numpy(), want_w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("position", [4097, 10000, 163839])
def test_yarn_cos_sin_match_deepseeks_formulas(position):
    """DeepseekV3YarnRotaryEmbedding at positions past the original 4,096:
    the frequencies interpolated between theta^(-2i/d) and that over the
    factor by a linear ramp over the correction range, times mscale(40, 1) /
    mscale(40, 1) = 1."""
    dim, base, factor, orig = 64, 10000.0, 40.0, 4096
    fast, slow = 32.0, 1.0

    def correction(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(correction(fast)), 0), min(math.ceil(correction(slow)), dim - 1)
    inv = []
    for i in range(dim // 2):
        extra = base ** (-2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        inv.append(extra / factor * ramp + extra * (1 - ramp))
    yarn = YarnRope(factor=factor, original_max_position_embeddings=orig)
    freqs = yarn_inv_freq(dim, base, yarn)
    np.testing.assert_allclose(freqs, inv, rtol=1e-6)
    cos, sin = yarn_rope_table(torch.tensor([position]), dim, base, yarn)
    # the program's angle is float32 (position x frequency): an ulp of a
    # frequency moves it by position x 6e-8 rad, so compare with the cos and
    # sin of the same float32 angles, to float32's rounding of them
    angles = np.concatenate([freqs, freqs]) * np.float32(position)
    np.testing.assert_allclose(cos[0].numpy(), np.cos(angles.astype(np.float64)), atol=1e-6)
    np.testing.assert_allclose(sin[0].numpy(), np.sin(angles.astype(np.float64)), atol=1e-6)


ARCH_DIMS_FULL = {**DIMS, "decoder": {**DIMS["decoder"], "qk_nope_head_dim": 128,
                                      "qk_rope_head_dim": 64, "v_head_dim": 128,
                                      "rope_scaling": {**YARN,
                                                       "original_max_position_embeddings": 4096}}}


def test_softmax_scale_is_deepseeks():
    ds = ARCH.program_config(ARCH_DIMS_FULL).decoder.deepseek
    want = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert ds.softmax_scale == pytest.approx(want, rel=1e-12)
    assert ref.softmax_scale(ARCH_DIMS_FULL["decoder"]) == pytest.approx(want, rel=1e-12)



@pytest.mark.parametrize("lengths", [[1, 9, 0, 30], [16, 17, 31, 2]])
def test_latent_kernel_fallback_matches_expanded_attention(lengths):
    """The absorbed decode (each head's query through W_UK, the paged latent
    call, W_UV after) equals attention with keys [W_UK c | k_pe] and values
    W_UV c expanded per head; empty rows give zeros."""
    g = torch.Generator().manual_seed(11)
    heads, rank, rope, dn, page_size, width = 4, 32, 8, 16, 8, 4
    n_pages = len(lengths) * width + 1
    pool = torch.randn(1, n_pages * page_size, rank + rope, generator=g)
    tables = (torch.randperm(n_pages - 1, generator=g)[:len(lengths) * width] + 1).view(
        len(lengths), width).int()
    lens = torch.tensor(lengths, dtype=torch.int32)
    q_nope = torch.randn(len(lengths), heads, dn, generator=g)
    q_pe = torch.randn(len(lengths), heads, rope, generator=g)
    w_uk = torch.randn(rank, heads, dn, generator=g) * 0.2
    w_uv = torch.randn(rank, heads, dn, generator=g) * 0.2
    scale = 0.3
    q = torch.cat([torch.einsum("shd,chd->shc", q_nope, w_uk), q_pe], -1)
    o_lat = mla_paged_decode(q, pool, tables, lens, page_size, rank, scale)
    got = torch.einsum("shc,chd->shd", o_lat, w_uv)
    pos = torch.arange(width * page_size)
    rows = pool[0][tables[:, pos // page_size].long() * page_size + pos % page_size]
    c, k_pe = rows[..., :rank], rows[..., rank:]
    k = torch.einsum("stc,chd->sthd", c, w_uk)
    v = torch.einsum("stc,chd->sthd", c, w_uv)
    scores = (torch.einsum("shd,sthd->sht", q_nope, k)
              + torch.einsum("shd,std->sht", q_pe, k_pe)) * scale
    seen = pos[None, :] < lens[:, None]
    probs = torch.softmax(scores.masked_fill(~seen[:, None], float("-inf")), -1).nan_to_num(0.0)
    want = torch.einsum("sht,sthd->shd", probs, v)
    assert float((got - want).abs().max()) <= TOL
    assert float(got[lens == 0].abs().max() if (lens == 0).any() else 0.0) == 0.0
    assert torch.equal(o_lat, mla_decode_reference(q, pool, tables, lens, page_size, rank, scale))


def test_a_served_image_pad_is_embedded_as_a_token(weights):
    """A served token equal to the image pad id (a random model can draw
    it) is embedded from the table, as the program embeds a generated
    token: only the prompt's pads take the vision tokens, in the reference
    and in the benchmark's copy of it, whose gaps agree (TOL)."""
    pixels = page()
    vision = ref.page_tokens(weights, DIMS, pixels)
    ids = ARCH.prompt_ids("read", vision.shape[0], DIMS)
    pad = DIMS["special"]["imgpad_id"]
    served = [pad, 40, pad, 41]
    x = ref.embed(weights, DIMS, ids + served[:-1], vision)
    assert torch.equal(x[len(ids)], weights["decoder"]["embed"][pad].float())
    assert torch.equal(x[[i for i, t in enumerate(ids) if t == pad]], vision.float())
    logits = ref.forward(weights, DIMS, ids + served[:-1], vision)[len(ids) - 1:]
    want = logits.amax(1) - logits.gather(1, torch.tensor(served)[:, None])[:, 0]
    got = ARCH.served_gaps(weights, DIMS, "none", pixels, "read", served)
    assert float((got - want).abs().max()) <= TOL


def test_moe_block_counts_its_assignments(weights):
    ds = ARCH.program_config(DIMS).decoder.deepseek
    m = {k: w[0] for k, w in weights["decoder"]["moe"].items()}
    s = {k: w[0] for k, w in weights["decoder"]["shared"].items()}
    x = torch.randn(3, 10, 64, generator=torch.Generator().manual_seed(2))
    live = torch.arange(10)[None, :] < torch.tensor([10, 4, 0])[:, None]
    stats = torch.zeros(3, 2, dtype=torch.int64)
    program_moe.moe_block(x, m, s, ds, live, stats)
    idx, _ = ref.route(x.reshape(-1, 64), m["router"], m["correction"], DIMS["decoder"])
    held = ((idx >= 4) & (idx < 8)).view(3, 10, -1) & live[..., None]
    assert stats[:, 0].tolist() == held.sum((1, 2)).tolist()
    per_expert = [int(((idx.view(3, 10, -1) == e) & live[..., None]).sum()) for e in range(4, 8)]
    assert stats[0, 1] == max(per_expert) and stats[1:, 1].tolist() == [0, 0]


def test_mla_refuses_int8_kv_and_speculation(weights):
    cfg = ARCH.program_config(DIMS)
    params = ARCH.serve_params(weights, DIMS, "none", "none")
    for sched in (SchedulerConfig(num_pages=16, page_size=8, kv_cache_dtype="int8"),
                  SchedulerConfig(num_pages=16, page_size=8, speculate_k=2)):
        with pytest.raises(ValueError):
            ContinuousBatchingEngine(params, cfg, torch.device("cpu"), sched=sched)


def test_the_control_serves_int8_weights(weights):
    """QUANTIZE int8 (the cell's control) quantizes the MLA query and output
    projections, the dense and shared MLPs, the embedding and the lm_head,
    and serves."""
    params = ARCH.serve_params(weights, DIMS, "int8", "int8")
    d = params["decoder"]
    assert all(isinstance(d["blocks"]["attn"][k], dict) for k in ("q_a", "q_b", "wo"))
    assert not isinstance(d["blocks"]["attn"]["kv_b"], dict)
    assert all(isinstance(d[g][k], dict) for g in ("dense", "shared") for k in ("gate", "up"))
    assert isinstance(d["lm_head"], dict) and not isinstance(d["moe"]["gate"], dict)
    engine = ContinuousBatchingEngine(params, ARCH.program_config(DIMS), torch.device("cpu"),
                                      sched=SchedulerConfig(num_pages=64, page_size=8,
                                                            max_slots=2, max_pages_per_seq=16))
    out = engine.generate_batch(["hello"], temperature=0.0, max_new_tokens=6)
    assert engine.metrics["generated_tokens"] + engine.metrics["prefills"] == 6 and out
