"""The port's checkpoint loader against the JAX package's on the CPU: the
counterparts of ``tests/test_loader.py``'s 9 cases on the tiny config,
then checkpoints crossing between the packages (a directory written by the
JAX ``export_hf_state_dict`` loads into the port with parameters equal to
the JAX loader's, and the other way round), and the port's own
safetensors reader and writer against the ``safetensors`` package's
``safe_open`` in float32 and bf16."""

import json

import jax
import numpy as np
import pytest
import torch

from dots_ocr_tpu.models import loader as jloader
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import init_params, param_shapes
from dots_ocr_tpu_torch.models.loader import (
    CheckpointFormatError,
    config_from_hf,
    export_hf_state_dict,
    hf_config_dict,
    load_checkpoint,
    map_hf_state_dict,
    read_safetensors,
    save_checkpoint,
    write_safetensors,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cfg():
    return DotsOCRConfig.tiny()


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, CPU, torch.Generator().manual_seed(1))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32),
                                      err_msg="/".join(path))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.float().numpy()


def test_roundtrip_identity(cfg, params):
    loaded = map_hf_state_dict(export_hf_state_dict(params, cfg), cfg)
    _assert_trees_equal(_np_tree(params), _np_tree(loaded))


def test_fused_qkv_split(cfg, params):
    state = export_hf_state_dict(params, cfg)
    for i in range(cfg.vision.num_layers):
        for kind in ("weight", "bias"):
            parts = [state.pop(f"vision_tower.blocks.{i}.attn.{p}_proj.{kind}") for p in "qkv"]
            state[f"vision_tower.blocks.{i}.attn.qkv.{kind}"] = np.concatenate(parts, 0)
    loaded = map_hf_state_dict(state, cfg)
    for key in ("wq", "wk", "wv", "bq", "bk", "bv"):
        assert torch.equal(loaded["vision"]["blocks"]["attn"][key],
                           params["vision"]["blocks"]["attn"][key])


def test_unmapped_tensor_raises(cfg, params):
    state = export_hf_state_dict(params, cfg)
    state["mystery.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(CheckpointFormatError, match="unmapped"):
        map_hf_state_dict(state, cfg)


def test_missing_layer_raises(cfg, params):
    state = export_hf_state_dict(params, cfg)
    del state["model.layers.1.self_attn.q_proj.weight"]
    with pytest.raises(CheckpointFormatError):
        map_hf_state_dict(state, cfg)


def test_shape_mismatch_raises(cfg, params):
    state = export_hf_state_dict(params, cfg)
    state["model.norm.weight"] = np.zeros((7,), np.float32)
    with pytest.raises(CheckpointFormatError, match="shape mismatch"):
        map_hf_state_dict(state, cfg)


def test_load_checkpoint_from_dir(tmp_path, cfg, params):
    from safetensors.numpy import save_file

    save_file(export_hf_state_dict(params, cfg), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_config_dict(cfg)))
    loaded_cfg, loaded = load_checkpoint(str(tmp_path))
    assert loaded_cfg.decoder.num_layers == cfg.decoder.num_layers
    assert loaded_cfg.vision.hidden_size == cfg.vision.hidden_size
    # dtype defaults to bf16 for the loaded flagship-style config
    assert loaded_cfg.dtype == "bfloat16"
    assert [tuple(s) for _, s in _leaves(param_shapes(loaded_cfg))] == \
        [tuple(t.shape) for _, t in _leaves(loaded)]
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(loaded))


def test_config_from_hf_defaults():
    cfg = config_from_hf({})
    assert cfg.decoder.num_layers == 28
    assert cfg.vision.num_layers == 42
    assert cfg.decoder.num_kv_heads == 2
    assert cfg.vision.window_size == 0
    assert cfg.vision.full_attn_layers == ()


def test_config_from_hf_window_autodetect_qwen_pixels():
    cfg = config_from_hf({"vision_config": {"patch_size": 14, "window_size": 112,
                                            "fullatt_block_indexes": [7, 15, 23, 31]}})
    assert cfg.vision.window_size == 8
    assert cfg.vision.full_attn_layers == (7, 15, 23, 31)


def test_config_from_hf_window_patch_units():
    cfg = config_from_hf({"vision_config": {"patch_size": 14, "window_size": 16}})
    assert cfg.vision.window_size == 16


@pytest.mark.parametrize("hf", [
    {}, {"vision_config": {"patch_size": 14, "window_size": 112, "fullatt_block_indexes": [1]}},
    {"hidden_size": 256, "num_attention_heads": 4, "vision_config": {"embed_dim": 128}},
])
def test_config_from_hf_equals_jax(hf):
    ours, theirs = config_from_hf(hf), jloader.config_from_hf(hf)
    for part in ("vision", "decoder", "special"):
        assert vars(getattr(ours, part)) == vars(getattr(theirs, part))


def test_jax_exported_checkpoint_loads_equal(tmp_path):
    """A directory written with the JAX exporter (safetensors' own writer)
    loads into the port with the JAX loader's parameters, and the port's
    save_checkpoint writes one the JAX loader reads back equal."""
    from safetensors.numpy import save_file

    jcfg = JaxConfig.tiny()
    jparams = jax_init(jax.random.PRNGKey(3), jcfg, scale=0.3)
    save_file(jloader.export_hf_state_dict(jparams, jcfg), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_config_dict(DotsOCRConfig.tiny())))
    jc, jp = jloader.load_checkpoint(str(tmp_path), config=jcfg)
    tc, tp = load_checkpoint(str(tmp_path), config=DotsOCRConfig.tiny())
    _assert_trees_equal(jax.tree.map(np.asarray, jp), _np_tree(tp))

    out = tmp_path / "port"
    save_checkpoint(str(out), tp, DotsOCRConfig.tiny())
    jc2, jp2 = jloader.load_checkpoint(str(out), config=jcfg)
    _assert_trees_equal(jax.tree.map(np.asarray, jp2), _np_tree(tp))
    assert jloader.load_checkpoint(str(out))[0].decoder == jc2.decoder


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_safetensors_reader_equals_safe_open(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file

    rng = np.random.RandomState(0)
    tensors = {"a": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
               "b.weight": torch.from_numpy(rng.randn(7).astype(np.float32)),
               "empty": torch.zeros((0, 4)), "ids": torch.arange(10, dtype=torch.int64)}
    tensors = {k: (v.to(getattr(torch, dtype)) if v.is_floating_point() else v)
               for k, v in tensors.items()}
    theirs_path = str(tmp_path / "theirs.safetensors")
    ours_path = str(tmp_path / "ours.safetensors")
    save_file(tensors, theirs_path)
    write_safetensors(ours_path, tensors)
    for path in (theirs_path, ours_path):
        ours = read_safetensors(path)
        with safe_open(path, framework="pt") as f:
            assert sorted(f.keys()) == sorted(ours)
            for key in f.keys():
                ref = f.get_tensor(key)
                assert ours[key].dtype == ref.dtype and torch.equal(ours[key], ref), key
