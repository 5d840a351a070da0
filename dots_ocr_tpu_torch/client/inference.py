"""HTTP inference client, wire-compatible with the reference's vLLM client.

Reproduces ``dots_ocr/model/inference.py:7-48`` without the OpenAI SDK
dependency: a plain POST to ``{addr}/v1/chat/completions`` with the image as
a base64 data URL and the text prefixed with the literal
``<|img|><|imgpad|><|endofimg|>`` placeholder (the server expands it; the
prefix also matches what the trained model expects before the prompt).

Works against this framework's server (``dots_ocr_tpu_torch/serve/server.py``) and
against any OpenAI-compatible endpoint (including an actual vLLM server),
keeping the parser portable across backends.
"""

from __future__ import annotations

import os
from typing import Optional

import requests

from dots_ocr_tpu_torch.utils.image_io import pil_to_base64

DEFAULT_TIMEOUT_S = 3600


def inference_with_server(
    image,
    prompt: str,
    protocol: str = "http",
    ip: str = "localhost",
    port: int = 8000,
    temperature: float = 0.1,
    top_p: float = 0.9,
    max_completion_tokens: int = 32768,
    model_name: str = "model",
    system_prompt: Optional[str] = None,
    seed: Optional[int] = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> Optional[str]:
    """One chat-completion request for one page. Returns the generated text,
    or None on a transport error (matching the reference's swallow-and-None
    behavior at inference.py:46-48, which the batch layer's retry logic
    depends on)."""
    addr = f"{protocol}://{ip}:{port}/v1/chat/completions"
    messages = []
    if system_prompt:
        messages.append({"role": "system", "content": system_prompt})
    content = []
    if image is not None:
        content.append(
            {"type": "image_url", "image_url": {"url": pil_to_base64(image)}}
        )
    content.append(
        {"type": "text", "text": f"<|img|><|imgpad|><|endofimg|>{prompt}"}
        if image is not None
        else {"type": "text", "text": prompt}
    )
    messages.append({"role": "user", "content": content})

    payload = {
        "messages": messages,
        "model": model_name,
        "max_completion_tokens": max_completion_tokens,
        "temperature": temperature,
        "top_p": top_p,
    }
    if seed is not None:
        # Reproducible sampled parses (eval sweeps): the TPU server's
        # position-keyed chains make this bit-stable under co-batching.
        payload["seed"] = seed
    headers = {
        "Content-Type": "application/json",
        "Authorization": f"Bearer {os.environ.get('API_KEY', '0')}",
    }
    try:
        response = requests.post(addr, json=payload, headers=headers, timeout=timeout)
        response.raise_for_status()
        data = response.json()
        return data["choices"][0]["message"]["content"]
    except requests.exceptions.RequestException as e:
        print(f"request error: {e}")
        return None


# Reference-compatible alias (the reference calls this inference_with_vllm).
inference_with_vllm = inference_with_server
