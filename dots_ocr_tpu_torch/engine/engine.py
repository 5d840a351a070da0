"""InferenceEngine: the in-process image + prompt -> text path over the
batch generate loop (port of ``dots_ocr_tpu.engine.engine``).

It owns params, tokenizer and the device. Requests are preprocessed on the
host (smart-resize -> patchify -> prompt ids) and run with bucketed
shapes through :func:`~dots_ocr_tpu_torch.engine.generate.generate`, over
a dense KV cache. The parser's local mode uses it; the OpenAI server
serves it with ``--engine batch``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch
from PIL import Image

from dots_ocr_tpu_torch.engine.chat_template import build_prompt_ids
from dots_ocr_tpu_torch.engine.generate import bucket_length, generate
from dots_ocr_tpu_torch.engine.sampling import prng_key, split
from dots_ocr_tpu_torch.engine.scheduler import default_tokenizer
from dots_ocr_tpu_torch.engine.tokenizer import TokenizerLike, load_checkpoint_tokenizer
from dots_ocr_tpu_torch.models import preprocess
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import init_params
from dots_ocr_tpu_torch.models.vlm import build_scatter_indices
from dots_ocr_tpu_torch.utils.consts import MAX_PIXELS, MIN_PIXELS
from dots_ocr_tpu_torch.utils.image_io import fetch_image

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RequestStats:
    prompt_tokens: int = 0
    vision_tokens: int = 0
    completion_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0


class InferenceEngine:
    """Single-batch engine over the dense-cache generate loop."""

    def __init__(
        self,
        params,
        config: DotsOCRConfig,
        tokenizer: Optional[TokenizerLike] = None,
        prompt_bucket_step: int = 128,
        vision_bucket_step: int = 512,
        default_max_new_tokens: int = 16384,
        attn_impl: str = "auto",
        device: Union[str, torch.device, None] = None,
    ):
        self.params = params
        self.config = config
        self.device = torch.device(device) if device is not None else _params_device(params)
        self.tokenizer = tokenizer or default_tokenizer(config)
        self.prompt_bucket_step = prompt_bucket_step
        self.vision_bucket_step = vision_bucket_step
        self.default_max_new_tokens = default_max_new_tokens
        if attn_impl == "auto":
            # The flash kernel on the card; on the CPU the JAX package's own
            # CPU path (dense attention), so tokens match its engine.
            attn_impl = "kernel" if self.device.type == "cuda" else "xla"
        self.attn_impl = attn_impl
        self._rng = prng_key(0)
        self.last_stats = RequestStats()

    @classmethod
    def from_pretrained(
        cls, model_path: str, config: Optional[DotsOCRConfig] = None,
        device: Union[str, torch.device] = "cuda", **kwargs
    ) -> "InferenceEngine":
        """Load an HF-format checkpoint directory onto ``device``, with its
        tokenizer.json when it has one (else the byte tokenizer on the
        config's special ids; the JAX package takes its byte tokenizer's
        default ids there, which a flagship config does not use)."""
        from dots_ocr_tpu_torch.engine.chat_template import load_checkpoint_template
        from dots_ocr_tpu_torch.models.loader import load_checkpoint

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available")
        config, params = load_checkpoint(model_path, config=config, device=device)
        tokenizer = load_checkpoint_tokenizer(model_path)
        if load_checkpoint_template(model_path):
            logger.info("using the checkpoint's own chat template")
        return cls(params, config, tokenizer=tokenizer, device=device, **kwargs)

    @classmethod
    def random_init(
        cls, config: Optional[DotsOCRConfig] = None, seed: int = 0, zeros: bool = False,
        device: Union[str, torch.device] = "cuda", **kwargs
    ) -> "InferenceEngine":
        """Weightless engine (tests, smoke runs, throughput benches):
        random-normal weights from ``seed`` (or zeros) on ``device``."""
        config = config or DotsOCRConfig.tiny()
        device = torch.device(device)
        params = init_params(config, device, torch.Generator(device=device).manual_seed(seed))
        if zeros:
            params = _map(torch.zeros_like, params)
        return cls(params, config, device=device, **kwargs)

    # ------------------------------------------------------------------

    def _next_rng(self) -> torch.Tensor:
        self._rng, out = split(self._rng)
        return out

    def _prepare_images(
        self,
        images: Sequence[Union[Image.Image, str]],
        min_pixels: Optional[int],
        max_pixels: Optional[int],
    ) -> List[Image.Image]:
        return [
            fetch_image(img, min_pixels=min_pixels or MIN_PIXELS,
                        max_pixels=max_pixels or MAX_PIXELS)
            for img in images
        ]

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def generate_batch(
        self,
        prompts: Sequence[str],
        images_per_prompt: Sequence[Sequence[Union[Image.Image, str]]],
        temperature: Union[float, Sequence[float]] = 0.1,
        top_p: Union[float, Sequence[float]] = 1.0,
        max_new_tokens: Optional[int] = None,
        system_prompt: Optional[str] = None,
        min_pixels: Optional[int] = None,
        max_pixels: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> List[str]:
        """Run a synchronous batch: one generated string per prompt. The
        batch shares one key: PRNGKey(seed) when seeded, else the next split
        of the engine's chain."""
        assert len(prompts) == len(images_per_prompt)
        batch = len(prompts)
        max_new = max_new_tokens or self.default_max_new_tokens
        cfg = self.config
        merge = cfg.vision.spatial_merge_size**2
        grid = cfg.vision.patch_size * cfg.vision.spatial_merge_size

        # Host preprocessing: resize + pack all images across the batch.
        all_images: List[Image.Image] = []
        counts: List[List[int]] = []
        for images in images_per_prompt:
            resized = self._prepare_images(images, min_pixels, max_pixels)
            counts.append([(im.width // grid) * (im.height // grid) for im in resized])
            all_images.extend(resized)
        packed = None
        if all_images:
            packed = preprocess.pack_images(all_images, cfg.vision,
                                            bucket_step=self.vision_bucket_step)

        # Prompt ids with expanded image spans.
        ids_list = [
            build_prompt_ids(self.tokenizer, prompt, counts[i], system_prompt=system_prompt)
            for i, prompt in enumerate(prompts)
        ]
        max_len = max(len(ids) for ids in ids_list)
        t_bucket = bucket_length(max_len, self.prompt_bucket_step)
        input_ids = np.full((batch, t_bucket), cfg.special.pad_token_id, np.int64)
        seq_lens = np.zeros(batch, np.int64)
        for i, ids in enumerate(ids_list):
            input_ids[i, : len(ids)] = ids
            seq_lens[i] = len(ids)

        kwargs = {}
        if packed is not None:
            sb, sp_idx = build_scatter_indices(
                input_ids, cfg.special.imgpad_id, packed.patches.shape[0] // merge,
                valid_rows=packed.merged_valid_rows(merge),
            )
            kwargs = dict(
                patches=self._put(packed.patches), pos2d=self._put(packed.pos2d),
                segment_ids=self._put(packed.segment_ids),
                scatter_batch=self._put(sb), scatter_pos=self._put(sp_idx),
            )

        temp = np.broadcast_to(np.asarray(temperature, np.float32), (batch,)).copy()
        tp = np.broadcast_to(np.asarray(top_p, np.float32), (batch,)).copy()
        rng = prng_key(seed) if seed is not None else self._next_rng()

        t0 = time.perf_counter()
        result = generate(
            self.params, cfg, self._put(input_ids), self._put(seq_lens), rng,
            self._put(temp), self._put(tp), max_new_tokens=max_new,
            attn_impl=self.attn_impl, nucleus=bool(np.any(tp < 1.0)), **kwargs,
        )
        tokens = result.tokens.cpu().numpy()
        counts_out = result.num_generated.cpu().numpy()
        elapsed = time.perf_counter() - t0

        self.last_stats = RequestStats(
            prompt_tokens=int(seq_lens.sum()),
            vision_tokens=packed.num_merged if packed else 0,
            completion_tokens=int(counts_out.sum()),
            decode_seconds=elapsed,
        )

        texts = []
        eos = cfg.special.eos_token_id
        for i in range(batch):
            ids = tokens[i, : counts_out[i]].tolist()
            if ids and ids[-1] == eos:
                ids = ids[:-1]
            texts.append(self.tokenizer.decode(ids, skip_special_tokens=True))
        return texts

    def generate_one(
        self,
        prompt: str,
        images: Sequence[Union[Image.Image, str]] = (),
        **kwargs,
    ) -> str:
        return self.generate_batch([prompt], [list(images)], **kwargs)[0]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _params_device(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device
