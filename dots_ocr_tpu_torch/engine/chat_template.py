"""Chat templating + image-span expansion.

The reference client sends OpenAI chat messages whose user text is prefixed
with the literal image placeholder ``<|img|><|imgpad|><|endofimg|>``
(``dots_ocr/model/inference.py:33``); the server's chat template (Qwen2.5
``<|im_start|>`` format, applied with ``--chat-template-content-format
string``, ``docker/docker-compose.yml:38``) wraps it, and the processor
expands ``<|imgpad|>`` to one token per merged vision token.

[EXTERNAL — template text verified against the checkpoint's
chat_template.json at load time.]
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from dots_ocr_tpu_torch.engine.tokenizer import TokenizerLike

IMAGE_PLACEHOLDER = "<|img|><|imgpad|><|endofimg|>"

# Set by load_checkpoint_template(); None = builtin Qwen-style rendering.
_CHECKPOINT_TEMPLATE = None


def load_checkpoint_template(model_path: str) -> Optional[str]:
    """Load and activate the checkpoint's own Jinja chat template when
    present (chat_template.json / chat_template.jinja /
    tokenizer_config.json:chat_template) — full fidelity with whatever the
    model was trained on, rendered via jinja2."""
    global _CHECKPOINT_TEMPLATE
    import json
    import os

    template = None
    for name in ("chat_template.json", "tokenizer_config.json"):
        path = os.path.join(model_path, name)
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                template = data.get("chat_template")
                if template:
                    break
            except Exception:  # noqa: BLE001
                continue
    jinja_path = os.path.join(model_path, "chat_template.jinja")
    if template is None and os.path.exists(jinja_path):
        with open(jinja_path, encoding="utf-8") as f:
            template = f.read()
    if template:
        _CHECKPOINT_TEMPLATE = template
    return template


def render_chat(user_content: str, system_prompt: Optional[str] = None) -> str:
    """Chat rendering with generation prompt: the checkpoint's own Jinja
    template when loaded, else the builtin Qwen2.5-style format."""
    if _CHECKPOINT_TEMPLATE is not None:
        import jinja2

        messages = []
        if system_prompt:
            messages.append({"role": "system", "content": system_prompt})
        messages.append({"role": "user", "content": user_content})
        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
            ValueError(msg)
        )
        return env.from_string(_CHECKPOINT_TEMPLATE).render(
            messages=messages, add_generation_prompt=True
        )

    parts = []
    if system_prompt:
        parts.append(f"<|im_start|>system\n{system_prompt}<|im_end|>\n")
    parts.append(f"<|im_start|>user\n{user_content}<|im_end|>\n")
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def build_prompt_ids(
    tokenizer: TokenizerLike,
    prompt: str,
    num_image_tokens: Sequence[int] = (),
    system_prompt: Optional[str] = None,
    add_placeholder_if_missing: bool = True,
) -> List[int]:
    """Render + tokenize a request, expanding each image placeholder to its
    merged-vision-token count.

    ``num_image_tokens[i]`` is the merged token count of the i-th image. If
    the prompt lacks a placeholder but images are present, one is prepended
    per image (matching the reference client's hardcoded prefix).
    """
    n_placeholders = prompt.count(IMAGE_PLACEHOLDER)
    if num_image_tokens and n_placeholders == 0 and add_placeholder_if_missing:
        prompt = IMAGE_PLACEHOLDER * len(num_image_tokens) + prompt
        n_placeholders = len(num_image_tokens)
    if n_placeholders != len(num_image_tokens):
        raise ValueError(
            f"{n_placeholders} image placeholders but {len(num_image_tokens)} images"
        )

    text = render_chat(prompt, system_prompt)

    img_id = tokenizer.token_id("<|img|>")
    imgpad_id = tokenizer.token_id("<|imgpad|>")
    endofimg_id = tokenizer.token_id("<|endofimg|>")

    ids: List[int] = []
    image_idx = 0
    chunks = text.split(IMAGE_PLACEHOLDER)
    for i, chunk in enumerate(chunks):
        if i > 0:
            ids.append(img_id)
            ids.extend([imgpad_id] * int(num_image_tokens[image_idx]))
            ids.append(endofimg_id)
            image_idx += 1
        if chunk:
            ids.extend(tokenizer.encode(chunk))
    return ids
