"""Tokenizer layer: HF-tokenizers-backed (production) + byte-level fallback.

The reference outsources tokenization to the HF processor downloaded with
the checkpoint (``dots_ocr/parser.py:75``). Here the engine needs only an
``encode``/``decode`` pair plus special-token ids; production loads the
checkpoint's ``tokenizer.json`` via the Rust `tokenizers` library, and tests
and weightless benchmarks use a deterministic byte-level tokenizer with the
same special-token surface.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Protocol, Sequence

SPECIAL_TOKEN_STRINGS = [
    "<|endoftext|>",
    "<|im_start|>",
    "<|im_end|>",
    "<|img|>",
    "<|imgpad|>",
    "<|endofimg|>",
]


class TokenizerLike(Protocol):
    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...

    def token_id(self, token: str) -> int: ...

    @property
    def vocab_size(self) -> int: ...


class HFTokenizer:
    """Wrapper over a checkpoint's tokenizer.json (Qwen2 BPE family)."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        tok_file = path
        if os.path.isdir(path):
            tok_file = os.path.join(path, "tokenizer.json")
        self._tok = Tokenizer.from_file(tok_file)
        self._special_ids = {
            s: self._tok.token_to_id(s)
            for s in SPECIAL_TOKEN_STRINGS
            if self._tok.token_to_id(s) is not None
        }

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_id(self, token: str) -> int:
        tid = self._tok.token_to_id(token)
        if tid is None:
            raise KeyError(token)
        return tid

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


class ByteTokenizer:
    """Deterministic byte-level tokenizer for tests and weightless benches.

    Ids 0..255 are raw UTF-8 bytes; special tokens map to explicit ids
    supplied by the caller (matching the model config's SpecialTokens so the
    whole pipeline runs without a checkpoint).
    """

    def __init__(self, special_ids: Optional[Dict[str, int]] = None, vocab_size: int = 512):
        self._vocab_size = vocab_size
        defaults = {
            "<|endoftext|>": 256,
            "<|im_start|>": 257,
            "<|im_end|>": 258,
            "<|img|>": 259,
            "<|imgpad|>": 260,
            "<|endofimg|>": 261,
        }
        self._special = dict(defaults)
        if special_ids:
            self._special.update(special_ids)
        self._special_by_id = {v: k for k, v in self._special.items()}

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            if text[i] == "<":
                for s, tid in self._special.items():
                    if text.startswith(s, i):
                        out.append(tid)
                        i += len(s)
                        matched = True
                        break
            if not matched:
                out.extend(text[i].encode("utf-8"))
                i += 1
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        buf = bytearray()
        parts: List[str] = []
        for tid in ids:
            tid = int(tid)
            if tid < 256:
                buf.append(tid)
            else:
                if buf:
                    parts.append(buf.decode("utf-8", "replace"))
                    buf = bytearray()
                if not skip_special_tokens and tid in self._special_by_id:
                    parts.append(self._special_by_id[tid])
        if buf:
            parts.append(buf.decode("utf-8", "replace"))
        return "".join(parts)

    def token_id(self, token: str) -> int:
        return self._special[token]

    @property
    def vocab_size(self) -> int:
        return self._vocab_size


class IncrementalDetokenizer:
    """Streams stable text from a growing token-id sequence.

    Byte-level BPE decode is concatenative per token, but a UTF-8 character
    can span token boundaries — decoding an incomplete tail yields U+FFFD.
    ``push(ids)`` buffers tokens whose decode ends in a replacement char and
    emits only once the character completes, so the concatenation of all
    returned deltas always equals ``decode(all_ids)`` (modulo a bounded
    still-pending tail, flushed by ``flush()``).

    Powers the vLLM-parity serving features the reference relies on
    (``stop`` sequences + SSE streaming, /root/reference/dots_ocr/model/
    inference.py:38-43 via vLLM's OpenAI surface).
    """

    def __init__(self, tokenizer: TokenizerLike, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self._pending: List[int] = []

    def push(self, ids: Sequence[int]) -> str:
        """Feed newly generated ids; return newly stable text (maybe '')."""
        if not ids:
            return ""
        self._pending.extend(int(i) for i in ids)
        text = self._tok.decode(
            self._pending, skip_special_tokens=self._skip_special
        )
        if text.endswith("�") and len(self._pending) < 16:
            # Mid-character: hold everything (a UTF-8 char spans at most 4
            # bytes so a real split resolves within a few tokens; the length
            # guard stops genuinely invalid bytes from stalling the stream).
            return ""
        self._pending = []
        return text

    def flush(self) -> str:
        """Emit whatever is still pending (end of stream)."""
        if not self._pending:
            return ""
        text = self._tok.decode(
            self._pending, skip_special_tokens=self._skip_special
        )
        self._pending = []
        return text


def longest_stop_prefix_at_tail(text: str, stops: Sequence[str]) -> int:
    """Length of the longest tail of ``text`` that is a proper prefix of any
    stop string — the holdback a streamer must not emit yet (it may become a
    stop match once more tokens arrive)."""
    hold = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:k]):
                hold = max(hold, k)
                break
    return hold


def load_tokenizer(model_path: Optional[str]) -> TokenizerLike:
    """Load the checkpoint tokenizer if present, else the byte fallback."""
    if model_path:
        tok_file = (
            model_path
            if model_path.endswith(".json")
            else os.path.join(model_path, "tokenizer.json")
        )
        if os.path.exists(tok_file):
            return HFTokenizer(tok_file)
    return ByteTokenizer()


def load_checkpoint_tokenizer(model_path: str) -> Optional[TokenizerLike]:
    """The checkpoint directory's own tokenizer (tokenizer.json), or None
    when it has none: the engine then builds its byte tokenizer on the
    model config's special ids (as for random weights). A synthetic
    checkpoint written by ``models.loader.save_checkpoint`` has none."""
    if os.path.exists(os.path.join(model_path, "tokenizer.json")):
        return load_tokenizer(model_path)
    return None
