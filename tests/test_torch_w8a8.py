"""The port's W8A8 vision path against the JAX package on the CPU: the
vision-tree quantizer, ``linear`` with a ``{"qint8_act", "scale"}`` kernel
(dynamic per-row int8 activations, an exact int32 product), the padded
int8 product, and the vision encoder on a W8A8 tree.

Inputs come from numpy seeds and reach both frameworks as the same arrays.
Quantized integers must be equal; each float comparison states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.models import layers as jlayers
from dots_ocr_tpu.models import preprocess as jpre
from dots_ocr_tpu.models import quantize as jquant
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.models.rope import vision_rope_device as jax_vrope
from dots_ocr_tpu.models.vision import vision_forward as jax_vision_forward
from dots_ocr_tpu_torch.models import layers as tlayers
from dots_ocr_tpu_torch.models import preprocess as tpre
from dots_ocr_tpu_torch.models import quantize as tquant
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.models.rope import vision_rope_device
from dots_ocr_tpu_torch.models.vision import vision_forward
from test_torch_int4 import _flat_equal
from test_torch_model import _images

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny())
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), DotsOCRConfig.tiny(), CPU)
    return jparams, tparams


def test_quantize_vision_params_matches_jax(weights):
    """Only the vision block linears become W8A8: bytes and scales equal to
    the JAX package's; the patch embed, merger, norms, biases and the whole
    decoder stay the same tensors."""
    jparams, tparams = weights
    tq = tquant.quantize_vision_params(tparams)
    _flat_equal(tq, jquant.quantize_vision_params(jparams))
    blocks = tq["vision"]["blocks"]
    assert all(tquant.is_act_quantized_kernel(blocks[g][n]) for g, n in tquant.BLOCK_KERNELS)
    assert blocks["attn"]["wq"]["qint8_act"].dtype == torch.int8
    assert blocks["attn"]["bq"] is tparams["vision"]["blocks"]["attn"]["bq"]
    assert tq["vision"]["patch_embed"] is tparams["vision"]["patch_embed"]
    assert tq["vision"]["merger"] is tparams["vision"]["merger"]
    assert tq["decoder"] is tparams["decoder"]
    # the bare vision tree too, and twice is once
    assert tquant.quantize_vision_params(tq)["vision"]["blocks"]["mlp"]["up"] is blocks["mlp"]["up"]
    w = (0.1 * np.random.RandomState(0).randn(64, 48)).astype(np.float32)
    ja, ta = jquant.quantize_kernel_act(jnp.asarray(w)), tquant.quantize_kernel_act(_t(w))
    np.testing.assert_array_equal(ta["qint8_act"].numpy(), np.asarray(ja["qint8_act"]))
    np.testing.assert_array_equal(ta["scale"].numpy(), np.asarray(ja["scale"]))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_jax(dtype, with_bias):
    """x [3, 5, 64] with leading dims: equal codes and int32 products, and
    the float32 steps in the JAX order (``acc * a_scale * s``, then the
    bias, then the cast), so equal to the last bit. A zero row takes the
    1e-8 scale floor."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 64).astype(np.float32)
    x[1, 2] = 0.0
    w = (0.1 * rng.randn(64, 48)).astype(np.float32)
    b = rng.randn(48).astype(np.float32) if with_bias else None
    jq, tq = jquant.quantize_kernel_act(jnp.asarray(w)), tquant.quantize_kernel_act(_t(w))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    ref = _np(jlayers.linear(jx, jq, None if b is None else jnp.asarray(b)))
    ours = tlayers.linear(tx, tq, None if b is None else _t(b))
    assert ours.dtype == tx.dtype and ours.shape == (3, 5, 48)
    np.testing.assert_array_equal(_np(ours), ref)


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int8_matmul_is_exact(rows):
    """The int8 product is exact at any row count (rows <= 16 are padded
    for ``torch._int_mm``), and large: |sum| up to 127^2 * 4224."""
    rng = np.random.RandomState(rows)
    xq = rng.randint(-127, 128, (rows, 4224)).astype(np.int8)
    q = rng.randint(-127, 128, (4224, 24)).astype(np.int8)
    xq[0] = 127
    q[:, 0] = 127
    ours = tlayers.int8_matmul(_t(xq), _t(q))
    assert ours.dtype == torch.int32 and ours.shape == (rows, 24)
    np.testing.assert_array_equal(ours.numpy(), xq.astype(np.int64) @ q.astype(np.int64))


def test_vision_forward_w8a8_matches_jax(weights):
    """The tiny encoder (2 blocks, float32) on a W8A8 tree, two packed
    images: within 1e-5 of JAX, the float encoder's tolerance in
    ``test_torch_model.py`` (the float32 paths around the int8 products
    differ in summation order only, and no code lands on a rounding tie
    here)."""
    jparams, tparams = weights
    cfg = DotsOCRConfig.tiny()
    jvis = jquant.quantize_vision_params(jparams)["vision"]
    tvis = tquant.quantize_vision_params(tparams)["vision"]
    packed = tpre.pack_images(_images(), cfg.vision, bucket_step=16)
    jpacked = jpre.pack_images(_images(), JaxConfig.tiny().vision, bucket_step=16)
    jc, js = jax_vrope(jnp.asarray(jpacked.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    ref = np.asarray(jax_vision_forward(jvis, JaxConfig.tiny().vision, jnp.asarray(jpacked.patches),
                                        jc, js, jnp.asarray(jpacked.segment_ids)))
    c, s = vision_rope_device(_t(packed.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    ours = vision_forward(tvis, cfg.vision, _t(packed.patches), c, s, _t(packed.segment_ids),
                          attn_impl="xla").numpy()
    live = packed.segment_ids >= 0
    assert live.sum() > 0 and np.isfinite(ours).all()
    np.testing.assert_allclose(ours[live], ref[live], rtol=0, atol=1e-5)
    # W8A8 moves the encoder away from the float tree by the int8 noise only
    dense = vision_forward(tparams["vision"], cfg.vision, _t(packed.patches), c, s,
                           _t(packed.segment_ids), attn_impl="xla").numpy()
    assert 0 < np.abs(dense[live] - ours[live]).max() < 0.1 * np.abs(dense[live]).max()
