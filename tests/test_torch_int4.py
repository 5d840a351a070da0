"""The port's int4 weight-only path against the JAX package on the CPU:
packing, the quantizers (kernel, decoder tree with its per-kernel int8
fallback), the XLA oracle's twin, the plain version of kernel 5 against the
Pallas kernel in interpret mode (both modes), ``linear`` / ``int4_linear``
dispatch, and the weight bridge.

Inputs come from numpy seeds and reach both frameworks as the same arrays.
Quantized integers and scales must be equal; each float comparison states
its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.models import layers as jlayers
from dots_ocr_tpu.models import quantize as jquant
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.ops import int4_matmul as jint4
from dots_ocr_tpu_torch.models import config as tconfig
from dots_ocr_tpu_torch.models import layers as tlayers
from dots_ocr_tpu_torch.models import quantize as tquant
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.ops import int4_matmul as tint4
from test_int4_engine import aligned_tiny

CPU = torch.device("cpu")
# tests/test_int4.py's tolerance for the Pallas kernel against its oracle.
PALLAS_TOL = dict(rtol=0.02, atol=0.02)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x) + 1e-30)) - 7)


def port_config(jcfg):
    """The port's twin of a JAX DotsOCRConfig."""
    return tconfig.DotsOCRConfig(
        vision=tconfig.VisionConfig(**dataclasses.asdict(jcfg.vision)),
        decoder=tconfig.DecoderConfig(**dataclasses.asdict(jcfg.decoder)),
        special=tconfig.SpecialTokens(**dataclasses.asdict(jcfg.special)),
        dtype=jcfg.dtype)


def _weights(in_dim, out_dim, seed, lead=()):
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(*lead, in_dim, out_dim)).astype(np.float32)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_unpack_bit_equal_to_jax(lead):
    rng = np.random.RandomState(0)
    q = rng.randint(-7, 8, lead + (512, 256)).astype(np.int8)
    jpack = jint4.pack_int4 if not lead else jax.vmap(jint4.pack_int4)
    ours = tint4.pack_int4(_t(q))
    assert ours.dtype == torch.int8 and ours.shape == lead + (256, 256)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jpack(jnp.asarray(q))))
    np.testing.assert_array_equal(tint4.unpack_int4(ours).numpy(), q)
    if not lead:
        np.testing.assert_array_equal(
            np.asarray(jint4.unpack_int4(jnp.asarray(ours.numpy()))), q)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_quantize_kernel_int4_matches_jax(lead):
    w = _weights(512, 384, 1, lead)
    w[..., 130, 7] = 3.0  # an outlier in one group
    w[..., :128, 5] = 0.0  # an all-zero group takes the 1e-8 floor
    jq = (jquant.quantize_kernel_int4 if not lead
          else jax.vmap(jquant.quantize_kernel_int4))(jnp.asarray(w))
    tq = tquant.quantize_kernel_int4(_t(w))
    assert tquant.is_int4_kernel(tq) and tq["qint4"].shape == lead + (256, 384)
    assert tq["scale4"].shape == lead + (4, 384) and tq["scale4"].dtype == torch.float32
    np.testing.assert_array_equal(tq["qint4"].numpy(), np.asarray(jq["qint4"]))
    np.testing.assert_array_equal(tq["scale4"].numpy(), np.asarray(jq["scale4"]))
    if not lead:
        packed, scales, _ = tint4.quantize_int4_np(w)
        np.testing.assert_array_equal(tq["qint4"].numpy(), packed)
        np.testing.assert_array_equal(tq["scale4"].numpy(), scales)


def test_int4_compatible_and_markers():
    assert tquant.int4_compatible(torch.zeros(256, 128))
    assert tquant.int4_compatible(torch.zeros(4, 512, 256))
    assert not tquant.int4_compatible(torch.zeros(100, 128))
    assert not tquant.int4_compatible(torch.zeros(256, 100))
    assert not tquant.int4_compatible({"qint8": None, "scale": None})
    assert tquant.is_act_quantized_kernel({"qint8_act": 0, "scale": 0})
    assert not tquant.is_int4_kernel({"qint8": 0, "scale": 0})


def _flat_equal(ours, ref_tree):
    ref_flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, ref_tree))[0]
    our_flat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    assert {p for p, _ in ref_flat} == set(our_flat)
    for path, ref in ref_flat:
        got = our_flat[path].numpy()
        assert got.dtype == ref.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(got, ref, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("config", ["tiny", "aligned_tiny"])
def test_quantize_decoder_params_int4_matches_jax(config):
    """The stock tiny config (hidden 64) falls back to int8 kernel by
    kernel; the aligned one (hidden 256) goes int4. The embedding is int8
    in both, and everything else stays the same tensor."""
    jcfg = JaxConfig.tiny() if config == "tiny" else aligned_tiny()
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), port_config(jcfg), CPU)
    tq = tquant.quantize_decoder_params_int4(tparams)
    _flat_equal(tq, jquant.quantize_decoder_params_int4(jparams))
    blocks = tq["decoder"]["blocks"]
    kinds = {tquant.is_int4_kernel(blocks[g][n]) for g, n in tquant.BLOCK_KERNELS}
    assert kinds == {config == "aligned_tiny"}
    assert tquant.is_quantized_kernel(tq["decoder"]["embed"])
    assert tq["vision"] is tparams["vision"]
    assert blocks["attn"]["bq"] is tparams["decoder"]["blocks"]["attn"]["bq"]
    assert tquant.param_bytes(tq) < tquant.param_bytes(tparams)


def test_int4_reference_matches_jax():
    w = _weights(512, 384, 2)
    x = np.random.RandomState(3).randn(2, 5, 512).astype(np.float32)
    jq = jquant.quantize_kernel_int4(jnp.asarray(w))
    ref = np.asarray(jint4.int4_matmul_reference(jnp.asarray(x), jq["qint4"], jq["scale4"]))
    ours = tint4.int4_matmul_reference(_t(x), _t(jq["qint4"]), _t(jq["scale4"]))
    assert ours.dtype == torch.float32 and ours.shape == (2, 5, 384)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("rows", [1, 3, 17])
def test_int4_plain_matches_pallas_interpret(rows, act_quant):
    """The plain version follows the Pallas body's order of operations.
    W4A8 codes can differ by one at a rounding tie: the jitted Pallas body's
    ``amax / 127.0`` is compiled by XLA as a multiply by the float32
    reciprocal, where the plain version (and the CUDA kernel) divide."""
    w = _weights(512, 384, 4)
    x = (np.random.RandomState(rows).randn(rows, 512)).astype(np.float32)
    jq = jquant.quantize_kernel_int4(jnp.asarray(w))
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = _np(jint4.int4_matmul(xb, jq["qint4"], jq["scale4"], interpret=True,
                                act_quant=act_quant))
    xt = _t(x).to(torch.bfloat16)
    ours = tint4.int4_matmul_plain(xt, _t(jq["qint4"]), _t(jq["scale4"]), act_quant)
    assert ours.dtype == torch.bfloat16 and ours.shape == (rows, 384)
    np.testing.assert_allclose(_np(ours), ref, **PALLAS_TOL)
    # the wrapper runs the plain version for CPU tensors, and counts nothing
    before = (tint4.int4_matmul.launches, tint4.int4_matmul.w4a8_launches)
    wrapped = tint4.int4_matmul(xt, _t(jq["qint4"]), _t(jq["scale4"]), act_quant)
    assert torch.equal(wrapped, ours)
    assert (tint4.int4_matmul.launches, tint4.int4_matmul.w4a8_launches) == before


def _w4a8_ordered_split(x, packed, scales, cluster):
    """W4A8's decode regime emulated in torch at ``cluster`` ranks: each
    rank's group sums over its packed-row blocks (both groups of a block)
    as exact int64 products, each scaled once in float32; then the float32
    chain over every rank's terms in the Pallas order (every low group,
    then every high group), the row scale last, bf16."""
    xs, a_scale = tint4.quantize_rows(x)
    xi, q = xs.to(torch.int64), tint4.unpack_int4(packed).to(torch.int64)
    blocks = x.shape[1] // 2 // tint4.GROUP
    terms = {}
    for start, end in tint4.w4a8_ranges(x.shape[1], cluster):
        for kb in range(start, end):
            for g in (kb, blocks + kb):
                rows = slice(g * tint4.GROUP, (g + 1) * tint4.GROUP)
                terms[g] = (xi[:, rows] @ q[rows]).to(torch.float32) * scales[g]
    assert sorted(terms) == list(range(2 * blocks))  # every group once
    acc = torch.zeros(x.shape[0], packed.shape[1], dtype=torch.float32)
    for g in range(2 * blocks):
        acc = acc + terms[g]
    return (acc * a_scale).to(torch.bfloat16)


@pytest.mark.parametrize("rows,in_dim,out_dim", [(3, 512, 256), (17, 1280, 384),
                                                 (64, 768, 128)])
def test_w4a8_ordered_split_is_the_plain_version(rows, in_dim, out_dim):
    """The ordered split at every cluster size the kernel takes at these
    shapes (the plan's among them) is ``int4_matmul_plain(..., act_quant=True)``
    bit for bit, with an all-zero row; and within PALLAS_TOL of the JAX
    package's Pallas kernel in interpret mode (whose jitted row scale can
    differ by one ulp: ROADMAP queue C item 6)."""
    rng = np.random.RandomState(rows + in_dim)
    w = _weights(in_dim, out_dim, rows)
    x = rng.randn(rows, in_dim).astype(np.float32)
    x[1] = 0.0
    jq = jquant.quantize_kernel_int4(jnp.asarray(w))
    xt, packed, scales = _t(x).to(torch.bfloat16), _t(jq["qint4"]), _t(jq["scale4"])
    plain = tint4.int4_matmul_plain(xt, packed, scales, act_quant=True)
    plan = tint4.int4_w4a8_plan(rows, in_dim, out_dim, 132)
    clusters = sorted({c for _, c in tint4.w4a8_candidates(rows, in_dim, out_dim)})
    assert plan.regime == "split" and plan.cluster in clusters
    for cluster in clusters:
        assert torch.equal(_w4a8_ordered_split(xt, packed, scales, cluster), plain), cluster
    assert (plain[1] == 0).all()
    ref = _np(jint4.int4_matmul(jnp.asarray(x, jnp.bfloat16), jq["qint4"], jq["scale4"],
                                interpret=True, act_quant=True))
    np.testing.assert_allclose(_np(plain), ref, **PALLAS_TOL)


def test_int4_plain_and_reference_agree():
    """The Pallas-order plain version and the XLA oracle compute the same
    function: in W4A16 the float32 products are exact, so only the
    summation order (and the +8 bias' cancellation) differ."""
    w = _weights(1024, 256, 5)
    x = np.random.RandomState(6).randn(9, 1024).astype(np.float32)
    tq = tquant.quantize_kernel_int4(_t(w))
    plain = tint4.int4_matmul_plain(_t(x), tq["qint4"], tq["scale4"]).numpy()
    ref = tint4.int4_matmul_reference(_t(x), tq["qint4"], tq["scale4"]).numpy()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("act", ["0", "1"])
def test_int4_linear_leading_dims_match_jax_interpret(act, monkeypatch):
    """``int4_linear`` over [2, 3, in] with DOTS_INT4_ACT = 0 (W4A16) or 1
    (W4A8) against the JAX package's int4_linear through the Pallas kernel
    in interpret mode, which reads the same switch."""
    monkeypatch.setenv("DOTS_INT4_ACT", act)
    w = _weights(512, 256, 7)
    x = np.random.RandomState(8).randn(2, 3, 512).astype(np.float32)
    jq = jquant.quantize_kernel_int4(jnp.asarray(w))
    ref = _np(jint4.int4_linear(jnp.asarray(x, jnp.bfloat16), jq, impl="interpret"))
    ours = tint4.int4_linear(_t(x).to(torch.bfloat16), {k: _t(v) for k, v in jq.items()})
    assert ours.shape == (2, 3, 256) and ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours), ref, **PALLAS_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_linear_int4_matches_jax(with_bias, monkeypatch):
    """``linear`` with an int4 kernel over leading dims [3, 5, in], bf16:
    the int4 product is rounded to bf16, then biased in float32 and rounded
    again, as in the JAX package. Through the JAX package's CPU path (the
    "xla" implementation) it agrees within 1 bf16 ulp (the oracle's einsum
    order); through the plain version within the Pallas tolerance."""
    rng = np.random.RandomState(9)
    w = _weights(256, 128, 10)
    b = (0.1 * rng.randn(128)).astype(np.float32)
    x = rng.randn(3, 5, 256).astype(np.float32)
    jq = jquant.quantize_kernel_int4(jnp.asarray(w))
    bias = b if with_bias else None
    ref = _np(jlayers.linear(jnp.asarray(x, jnp.bfloat16), jq,
                             None if bias is None else jnp.asarray(bias)))
    tq = {k: _t(v) for k, v in jq.items()}
    xt, bt = _t(x).to(torch.bfloat16), None if bias is None else _t(bias)
    plain = tlayers.linear(xt, tq, bt)
    assert plain.shape == (3, 5, 128) and plain.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(plain), ref, **PALLAS_TOL)
    monkeypatch.setitem(tint4.IMPLEMENTATIONS, "kernel", tint4.IMPLEMENTATIONS["xla"])
    xla = _np(tlayers.linear(xt, tq, bt))
    assert (np.abs(xla - ref) <= _bf16_ulp(ref)).all()


def test_from_numpy_params_takes_int4_and_w8a8_leaves():
    jcfg = aligned_tiny()
    jparams = jax_init(jax.random.PRNGKey(1), jcfg)
    jtree = jquant.quantize_vision_params(jquant.quantize_decoder_params_int4(jparams))
    tparams = from_numpy_params(jax.tree.map(np.asarray, jtree), port_config(jcfg), CPU)
    _flat_equal(tparams, jtree)
    wq = tparams["decoder"]["blocks"]["attn"]["wq"]
    assert wq["qint4"].dtype == torch.int8 and wq["qint4"].shape == (2, 128, 256)
    assert wq["scale4"].shape == (2, 2, 256)
    assert tparams["vision"]["blocks"]["mlp"]["up"]["qint8_act"].shape == (2, 32, 64)
    # a packed leaf of the wrong shape is refused
    bad = jax.tree.map(np.asarray, jtree)
    bad["decoder"]["blocks"]["mlp"]["up"]["scale4"] = np.zeros((2, 3, 512), np.float32)
    with pytest.raises(ValueError, match="mlp/up"):
        from_numpy_params(bad, port_config(jcfg), CPU)
