"""Checkpoint loading: HF safetensors -> the port's stacked parameter tree
(port of ``dots_ocr_tpu.models.loader``).

HF tensor names map into the stacked-layer tree of ``models/init.py``:

  * HF ``nn.Linear.weight`` is [out, in] -> transposed to [in, out],
  * per-layer tensors ``...layers.{i}...`` are stacked on a leading axis,
  * the 14x14 conv patch embed [D, C, kh, kw] is flattened to
    [kh*kw*C, D] matching ``preprocess.extract_patches`` pixel order
    (row-major patch pixels, channel-last),
  * fused qkv projections are split when the checkpoint fuses them.

The mapping runs in numpy, as in the JAX package; its last step checks
every leaf against ``init.param_shapes`` and puts torch tensors in the
config dtype on the device. Safetensors files are read (and written)
here, from the format itself: an 8-byte little-endian header length, a
JSON header, then raw little-endian tensor bytes, bf16 included (which
``safe_open(framework="np")`` cannot hold), with no dependency on the
``safetensors`` package.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import (
    DecoderConfig,
    DotsOCRConfig,
    SpecialTokens,
    VisionConfig,
)
from dots_ocr_tpu_torch.models.init import param_shapes


# ---------------------------------------------------------------------------
# config.json -> DotsOCRConfig
# ---------------------------------------------------------------------------


def config_from_hf(config_dict: Dict[str, Any]) -> DotsOCRConfig:
    """Build a DotsOCRConfig from an HF-style config.json dict."""
    vc = config_dict.get("vision_config", {}) or {}
    head_dim_v = vc.get("head_dim") or (
        vc.get("embed_dim", 1536) // vc.get("num_attention_heads", 12)
    )
    patch_size = vc.get("patch_size", 14)
    # Windowed attention, auto-detected from the checkpoint config
    # (Qwen2.5-VL convention: vision_config.window_size in PIXELS — e.g.
    # 112 px / 14 px patches = 8-patch windows — plus fullatt_block_indexes
    # naming the image-wide layers). VisionConfig counts window_size in RAW
    # PATCHES per side; values that look like pixels (multiples of
    # patch_size above one merge cell) are converted. Absent keys mean full
    # attention everywhere — the safe default until the checkpoint is
    # verified (docs/windowed_vision.md has the switch-on checklist).
    window_size = vc.get("window_size", 0) or 0
    if window_size and window_size % patch_size == 0 and window_size >= 4 * patch_size:
        window_size //= patch_size  # pixels -> raw patches
    full_layers = vc.get(
        "fullatt_block_indexes", vc.get("full_attn_layers", ())
    ) or ()
    vision = VisionConfig(
        hidden_size=vc.get("embed_dim", vc.get("hidden_size", 1536)),
        num_layers=vc.get("num_hidden_layers", vc.get("depth", 42)),
        num_heads=vc.get("num_attention_heads", vc.get("num_heads", 12)),
        head_dim=head_dim_v,
        intermediate_size=vc.get("intermediate_size", 4224),
        patch_size=patch_size,
        temporal_patch_size=vc.get("temporal_patch_size", 1),
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        rms_norm_eps=vc.get("rms_norm_eps", 1e-5),
        post_norm=vc.get("post_norm", True),
        qkv_bias=vc.get("use_bias", vc.get("qkv_bias", True)),
        window_size=int(window_size),
        full_attn_layers=tuple(int(i) for i in full_layers),
    )
    dc = config_dict
    head_dim_d = dc.get("head_dim") or (
        dc.get("hidden_size", 1536) // dc.get("num_attention_heads", 12)
    )
    decoder = DecoderConfig(
        vocab_size=dc.get("vocab_size", 151936),
        hidden_size=dc.get("hidden_size", 1536),
        num_layers=dc.get("num_hidden_layers", 28),
        num_heads=dc.get("num_attention_heads", 12),
        num_kv_heads=dc.get("num_key_value_heads", 2),
        head_dim=head_dim_d,
        intermediate_size=dc.get("intermediate_size", 8960),
        rms_norm_eps=dc.get("rms_norm_eps", 1e-6),
        rope_theta=dc.get("rope_theta", 1e6),
        tie_word_embeddings=dc.get("tie_word_embeddings", True),
        max_position_embeddings=dc.get("max_position_embeddings", 131072),
    )
    special = SpecialTokens(
        eos_token_id=dc.get("eos_token_id", 151645),
        pad_token_id=dc.get("pad_token_id", 151643),
        img_id=dc.get("image_token_id", dc.get("img_token_id", 151665)),
        imgpad_id=dc.get("image_pad_token_id", dc.get("imgpad_token_id", 151666)),
        endofimg_id=dc.get("image_end_token_id", dc.get("endofimg_token_id", 151667)),
    )
    return DotsOCRConfig(vision=vision, decoder=decoder, special=special)


# ---------------------------------------------------------------------------
# Tensor name mapping
# ---------------------------------------------------------------------------

# (regex over HF name) -> (pytree path template, needs_transpose)
# {i} is the layer index captured by the regex.
_DECODER_LAYER_MAP: List[Tuple[str, str, bool]] = [
    (r"self_attn\.q_proj\.weight", "attn.wq", True),
    (r"self_attn\.q_proj\.bias", "attn.bq", False),
    (r"self_attn\.k_proj\.weight", "attn.wk", True),
    (r"self_attn\.k_proj\.bias", "attn.bk", False),
    (r"self_attn\.v_proj\.weight", "attn.wv", True),
    (r"self_attn\.v_proj\.bias", "attn.bv", False),
    (r"self_attn\.o_proj\.weight", "attn.wo", True),
    (r"mlp\.gate_proj\.weight", "mlp.gate", True),
    (r"mlp\.up_proj\.weight", "mlp.up", True),
    (r"mlp\.down_proj\.weight", "mlp.down", True),
    (r"input_layernorm\.weight", "input_norm", False),
    (r"post_attention_layernorm\.weight", "post_attn_norm", False),
]

_VISION_LAYER_MAP: List[Tuple[str, str, bool]] = [
    (r"attn\.q_proj\.weight", "attn.wq", True),
    (r"attn\.q_proj\.bias", "attn.bq", False),
    (r"attn\.k_proj\.weight", "attn.wk", True),
    (r"attn\.k_proj\.bias", "attn.bk", False),
    (r"attn\.v_proj\.weight", "attn.wv", True),
    (r"attn\.v_proj\.bias", "attn.bv", False),
    (r"attn\.(?:proj|o_proj|out_proj)\.weight", "attn.wo", True),
    (r"mlp\.(?:gate_proj|fc13|w1)\.weight", "mlp.gate", True),
    (r"mlp\.(?:up_proj|w3)\.weight", "mlp.up", True),
    (r"mlp\.(?:down_proj|fc2|w2)\.weight", "mlp.down", True),
    (r"norm1\.weight", "norm1", False),
    (r"norm2\.weight", "norm2", False),
]

_VISION_PREFIXES = ("vision_tower.", "vision_model.", "visual.", "model.vision_tower.")
_DECODER_PREFIXES = ("model.language_model.", "model.", "language_model.model.")


def _set_path(tree: dict, dotted: str, value):
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


class CheckpointFormatError(ValueError):
    pass


def map_hf_state_dict(
    state: Dict[str, np.ndarray], config: DotsOCRConfig,
    device: Union[str, torch.device] = "cpu",
) -> Dict[str, Any]:
    """Map a flat HF state dict to the port's nested stacked tree, as torch
    tensors in the config dtype on ``device``."""
    vcfg, dcfg = config.vision, config.decoder

    # Collected per-layer tensors: {("decoder", "attn.wq"): {layer: array}}
    per_layer: Dict[Tuple[str, str], Dict[int, np.ndarray]] = {}
    tree: Dict[str, Any] = {"vision": {}, "decoder": {}}
    unmatched: List[str] = []

    def record(tower: str, path: str, layer: int, arr: np.ndarray):
        per_layer.setdefault((tower, path), {})[layer] = arr

    for name, arr in state.items():
        arr = np.asarray(arr)
        handled = False

        # ---- vision tower ----
        for prefix in _VISION_PREFIXES:
            if not name.startswith(prefix):
                continue
            sub = name[len(prefix):]
            m = re.match(r"blocks\.(\d+)\.(.+)", sub)
            if m:
                layer, rest = int(m.group(1)), m.group(2)
                # fused qkv
                fq = re.match(r"attn\.qkv\.(weight|bias)", rest)
                if fq:
                    kind = fq.group(1)
                    a = vcfg.num_heads * vcfg.head_dim
                    parts = np.split(arr, [a, 2 * a], axis=0)
                    for part, key in zip(parts, ("q", "k", "v")):
                        if kind == "weight":
                            record("vision", f"attn.w{key}", layer, part.T)
                        else:
                            record("vision", f"attn.b{key}", layer, part)
                    handled = True
                    break
                for pattern, path, transpose in _VISION_LAYER_MAP:
                    if re.fullmatch(pattern, rest):
                        record("vision", path, layer, arr.T if transpose else arr)
                        handled = True
                        break
                if handled:
                    break
            elif re.match(r"patch_embed\.(?:proj|patchifier\.proj)\.weight", sub):
                # conv [D, C, (t,) kh, kw] -> [kh*kw*C, D] (pixel-major,
                # channel-last: matches extract_patches layout).
                w = arr
                if w.ndim == 5:  # temporal conv dim
                    w = w[:, :, 0]
                d, c, kh, kw = w.shape
                w = w.transpose(2, 3, 1, 0).reshape(kh * kw * c, d)
                _set_path(tree, "vision.patch_embed.kernel", w)
                handled = True
            elif re.match(r"patch_embed\.(?:proj|patchifier\.proj)\.bias", sub):
                _set_path(tree, "vision.patch_embed.bias", arr)
                handled = True
            elif re.match(r"(?:post_trunk_norm|norm|ln_post)\.weight", sub):
                _set_path(tree, "vision.post_norm", arr)
                handled = True
            elif re.match(r"merger\.(?:ln_q|norm)\.weight", sub):
                _set_path(tree, "vision.merger.norm", arr)
                handled = True
            elif re.match(r"merger\.(?:mlp\.0|fc1)\.weight", sub):
                _set_path(tree, "vision.merger.fc1", arr.T)
                handled = True
            elif re.match(r"merger\.(?:mlp\.0|fc1)\.bias", sub):
                _set_path(tree, "vision.merger.b1", arr)
                handled = True
            elif re.match(r"merger\.(?:mlp\.2|fc2)\.weight", sub):
                _set_path(tree, "vision.merger.fc2", arr.T)
                handled = True
            elif re.match(r"merger\.(?:mlp\.2|fc2)\.bias", sub):
                _set_path(tree, "vision.merger.b2", arr)
                handled = True
            break
        if handled:
            continue

        # ---- decoder ----
        if name == "lm_head.weight":
            if not dcfg.tie_word_embeddings:
                _set_path(tree, "decoder.lm_head", arr.T)
            handled = True
        else:
            for prefix in _DECODER_PREFIXES:
                if not name.startswith(prefix):
                    continue
                sub = name[len(prefix):]
                if sub == "embed_tokens.weight":
                    _set_path(tree, "decoder.embed", arr)
                    handled = True
                elif sub == "norm.weight":
                    _set_path(tree, "decoder.final_norm", arr)
                    handled = True
                else:
                    m = re.match(r"layers\.(\d+)\.(.+)", sub)
                    if m:
                        layer, rest = int(m.group(1)), m.group(2)
                        for pattern, path, transpose in _DECODER_LAYER_MAP:
                            if re.fullmatch(pattern, rest):
                                record(
                                    "decoder", path, layer,
                                    arr.T if transpose else arr,
                                )
                                handled = True
                                break
                break
        if not handled:
            unmatched.append(name)

    if unmatched:
        raise CheckpointFormatError(
            f"unmapped checkpoint tensors ({len(unmatched)}): {unmatched[:20]}"
        )

    # Stack per-layer tensors.
    for (tower, path), layers in per_layer.items():
        expected = vcfg.num_layers if tower == "vision" else dcfg.num_layers
        missing = [i for i in range(expected) if i not in layers]
        if missing:
            raise CheckpointFormatError(
                f"{tower}.{path}: missing layers {missing[:8]}"
            )
        stacked = np.stack([layers[i] for i in range(expected)], axis=0)
        _set_path(tree, f"{tower}.blocks.{path}", stacked)

    # Validate against the shapes and convert.
    dtype = config.torch_dtype

    def convert(path: Tuple[str, ...], shape) -> torch.Tensor:
        node = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise CheckpointFormatError(f"missing param: {'/'.join(path)}")
            node = node[key]
        if tuple(node.shape) != tuple(shape):
            raise CheckpointFormatError(
                f"shape mismatch at {'/'.join(path)}: "
                f"checkpoint {node.shape} vs spec {tuple(shape)}"
            )
        arr = np.ascontiguousarray(node, np.float32)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    def walk(shapes, path=()):
        if isinstance(shapes, dict):
            return {k: walk(v, path + (k,)) for k, v in shapes.items()}
        return convert(path, shapes)

    return walk(param_shapes(config))


# ---------------------------------------------------------------------------
# Safetensors files
# ---------------------------------------------------------------------------

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU torch tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise CheckpointFormatError(f"{name}: unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                     offset=begin).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Dict[str, Union[np.ndarray, torch.Tensor]],
                      dtype: Optional[torch.dtype] = None) -> None:
    """Write tensors (numpy or torch) as one .safetensors file, cast to
    ``dtype`` when given (bf16 rounds to nearest even)."""
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name, arr in tensors.items():
        t = torch.as_tensor(arr).detach().cpu()
        if dtype is not None:
            t = t.to(dtype)
        t = t.contiguous()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    meta = json.dumps(header, separators=(",", ":")).encode()
    meta += b" " * (-len(meta) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(meta)))
        f.write(meta)
        for raw in blobs:
            f.write(raw)


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Every *.safetensors shard in a directory as one flat dict of numpy
    arrays (bf16 widened exactly to float32)."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state: Dict[str, np.ndarray] = {}
    for file in files:
        for key, t in read_safetensors(file).items():
            state[key] = (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()
    return state


def load_checkpoint(
    model_path: str, config: Optional[DotsOCRConfig] = None,
    device: Union[str, torch.device] = "cpu",
) -> Tuple[DotsOCRConfig, Dict[str, Any]]:
    """Load (config, params) from an HF-format checkpoint directory, params
    on ``device``."""
    if config is None:
        cfg_file = os.path.join(model_path, "config.json")
        with open(cfg_file) as f:
            config = config_from_hf(json.load(f))
    state = load_safetensors_dir(model_path)
    params = map_hf_state_dict(state, config, device=device)
    return config, params


# ---------------------------------------------------------------------------
# Export (inverse mapping): used by tests and to write synthetic checkpoints
# ---------------------------------------------------------------------------


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(x, np.float32)


def hf_config_dict(config: DotsOCRConfig) -> Dict[str, Any]:
    """An HF-style config.json dict that :func:`config_from_hf` maps back
    to ``config`` (its dtype aside: a loaded config is bf16)."""
    v, d, sp = config.vision, config.decoder, config.special
    return {
        "vocab_size": d.vocab_size,
        "hidden_size": d.hidden_size,
        "num_hidden_layers": d.num_layers,
        "num_attention_heads": d.num_heads,
        "num_key_value_heads": d.num_kv_heads,
        "head_dim": d.head_dim,
        "intermediate_size": d.intermediate_size,
        "rms_norm_eps": d.rms_norm_eps,
        "rope_theta": d.rope_theta,
        "tie_word_embeddings": d.tie_word_embeddings,
        "max_position_embeddings": d.max_position_embeddings,
        "eos_token_id": sp.eos_token_id,
        "pad_token_id": sp.pad_token_id,
        "image_token_id": sp.img_id,
        "image_pad_token_id": sp.imgpad_id,
        "image_end_token_id": sp.endofimg_id,
        "vision_config": {
            "embed_dim": v.hidden_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads,
            "head_dim": v.head_dim,
            "intermediate_size": v.intermediate_size,
            "patch_size": v.patch_size,
            "temporal_patch_size": v.temporal_patch_size,
            "spatial_merge_size": v.spatial_merge_size,
            "rms_norm_eps": v.rms_norm_eps,
            "post_norm": v.post_norm,
            "use_bias": v.qkv_bias,
            "window_size": v.window_size,
            "fullatt_block_indexes": list(v.full_attn_layers),
        },
    }


def save_checkpoint(path: str, params: Dict[str, Any], config: DotsOCRConfig,
                    dtype: Optional[torch.dtype] = None) -> None:
    """Write a synthetic HF checkpoint directory (config.json and
    model.safetensors through :func:`export_hf_state_dict`) that
    :func:`load_checkpoint` and the JAX package's loader read back;
    ``dtype`` (e.g. bf16) casts the float32 export."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(config), f, indent=1)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      export_hf_state_dict(params, config), dtype=dtype)


def export_hf_state_dict(params: Dict[str, Any], config: DotsOCRConfig) -> Dict[str, np.ndarray]:
    """Inverse of map_hf_state_dict (round-trip tested): the port's float
    parameter tree -> a flat HF state dict of float32 numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    v, d = params["vision"], params["decoder"]
    vcfg = config.vision

    k = _to_numpy(v["patch_embed"]["kernel"])  # [khkwC, D]
    p, c, dim = vcfg.patch_size, vcfg.in_channels, vcfg.hidden_size
    out["vision_tower.patch_embed.proj.weight"] = (
        k.reshape(p, p, c, dim).transpose(3, 2, 0, 1)
    )
    out["vision_tower.patch_embed.proj.bias"] = _to_numpy(v["patch_embed"]["bias"])
    out["vision_tower.post_trunk_norm.weight"] = _to_numpy(v["post_norm"])
    out["vision_tower.merger.ln_q.weight"] = _to_numpy(v["merger"]["norm"])
    out["vision_tower.merger.mlp.0.weight"] = _to_numpy(v["merger"]["fc1"]).T
    out["vision_tower.merger.mlp.0.bias"] = _to_numpy(v["merger"]["b1"])
    out["vision_tower.merger.mlp.2.weight"] = _to_numpy(v["merger"]["fc2"]).T
    out["vision_tower.merger.mlp.2.bias"] = _to_numpy(v["merger"]["b2"])

    vision_names = {
        "attn.wq": ("attn.q_proj.weight", True),
        "attn.bq": ("attn.q_proj.bias", False),
        "attn.wk": ("attn.k_proj.weight", True),
        "attn.bk": ("attn.k_proj.bias", False),
        "attn.wv": ("attn.v_proj.weight", True),
        "attn.bv": ("attn.v_proj.bias", False),
        "attn.wo": ("attn.proj.weight", True),
        "mlp.gate": ("mlp.gate_proj.weight", True),
        "mlp.up": ("mlp.up_proj.weight", True),
        "mlp.down": ("mlp.down_proj.weight", True),
        "norm1": ("norm1.weight", False),
        "norm2": ("norm2.weight", False),
    }

    def emit_blocks(blocks: dict, names: dict, prefix: str):
        def walk(node, path):
            if isinstance(node, dict):
                for key, sub in node.items():
                    walk(sub, f"{path}.{key}" if path else key)
                return
            hf_suffix, transpose = names[path]
            arr = _to_numpy(node)
            for i in range(arr.shape[0]):
                layer = arr[i].T if transpose else arr[i]
                out[f"{prefix}.{i}.{hf_suffix}"] = layer

        walk(blocks, "")

    emit_blocks(v["blocks"], vision_names, "vision_tower.blocks")

    decoder_names = {
        "attn.wq": ("self_attn.q_proj.weight", True),
        "attn.bq": ("self_attn.q_proj.bias", False),
        "attn.wk": ("self_attn.k_proj.weight", True),
        "attn.bk": ("self_attn.k_proj.bias", False),
        "attn.wv": ("self_attn.v_proj.weight", True),
        "attn.bv": ("self_attn.v_proj.bias", False),
        "attn.wo": ("self_attn.o_proj.weight", True),
        "mlp.gate": ("mlp.gate_proj.weight", True),
        "mlp.up": ("mlp.up_proj.weight", True),
        "mlp.down": ("mlp.down_proj.weight", True),
        "input_norm": ("input_layernorm.weight", False),
        "post_attn_norm": ("post_attention_layernorm.weight", False),
    }
    emit_blocks(d["blocks"], decoder_names, "model.layers")
    out["model.embed_tokens.weight"] = _to_numpy(d["embed"])
    out["model.norm.weight"] = _to_numpy(d["final_norm"])
    if "lm_head" in d:
        out["lm_head.weight"] = _to_numpy(d["lm_head"]).T
    return out
