"""Single-source shipping config loader.

``deploy/shipping.env`` is THE shipping serving config (reference analog:
the vLLM flags in ``docker/docker-compose.yml:35-40`` of the reference).
Shell consumers (launch_server_tpu.sh, docker-compose) read it natively;
Python consumers (bench.py, bench_suite.py) read it through here so every
entry point agrees on QUANTIZE/KV_DTYPE/PAGE_SIZE/... without duplication.

A copy of ``dots_ocr_tpu.utils.shipping``: both read the repository's one
``deploy/shipping.env``.
"""

from __future__ import annotations

import os
from typing import Dict

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "deploy",
    "shipping.env",
)

# Fallbacks if the env file is missing (e.g. an installed wheel without the
# deploy/ tree) — MUST mirror deploy/shipping.env.
_FALLBACK = {
    "PAGE_SIZE": "128",
    "KV_DTYPE": "bf16",
    "QUANTIZE": "int8",
    "SPECULATE_K": "2",  # re-derived r5: BENCH_SPEC_CURVE_r5.json
    "PREFILL_CHUNK": "2048",
    "NUM_PAGES": "2048",
    "MAX_SLOTS": "64",
    "MAX_SEQ_TOKENS": "40960",
    "STEPS_PER_SYNC": "16",
    "WARMUP": "full",
    "COMPILE_CACHE": ".cache/xla",
    "VISION_ATTN": "config",
    "VISION_WINDOW": "16",
    "VISION_FULL_LAYERS": "6,13,20,27,34,41",
}


def apply_vision_policy(config, ship: Dict[str, str] | None = None):
    """Apply the shipping VISION_ATTN policy to a DotsOCRConfig.

    'windowed' -> window VISION_WINDOW raw patches with VISION_FULL_LAYERS
    staying image-wide; 'full' -> image-wide everywhere; 'config' -> return
    unchanged (the checkpoint's own declared policy, models/loader.py).
    """
    import dataclasses

    ship = ship or shipping_config()
    mode = ship.get("VISION_ATTN", "config")
    if mode == "full":
        vision = dataclasses.replace(
            config.vision, window_size=0, full_attn_layers=()
        )
    elif mode == "windowed":
        full = tuple(
            int(i)
            for i in ship.get("VISION_FULL_LAYERS", "").split(",")
            if i.strip()
        )
        full = tuple(i for i in full if i < config.vision.num_layers)
        vision = dataclasses.replace(
            config.vision,
            window_size=int(ship.get("VISION_WINDOW", "16")),
            full_attn_layers=full,
        )
    else:  # "config"
        return config
    return config.replace(vision=vision)


def shipping_config(path: str | None = None) -> Dict[str, str]:
    """Parse deploy/shipping.env into a dict; falls back to baked defaults."""
    path = path or _DEFAULT_PATH
    cfg = dict(_FALLBACK)
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                cfg[k.strip()] = v.strip()
    except OSError:
        pass
    return cfg
