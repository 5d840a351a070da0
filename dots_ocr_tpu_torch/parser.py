"""DotsOCRParser: the end-to-end file -> artifacts pipeline.

The PyTorch port's copy of ``dots_ocr_tpu.parser``: the same code, with the
local engine the port's :class:`~dots_ocr_tpu_torch.engine.engine.InferenceEngine`
on a torch device (``device``, CUDA unless the caller asks for the CPU).

API-compatible rebuild of the reference parser
(``dots_ocr/parser.py:17-322``): same constructor knobs, same prompt modes,
same artifact layout ({name}.json / .jpg / .md / _nohf.md + {file}.jsonl
manifest), same bbox/markdown semantics — plus the ``custom_prompt`` and
``temperature`` per-call overrides the newer reference demos expect
(``demo/demo_gradio.py:346-354``).

Inference backends:
  * HTTP (default): OpenAI-compatible server (this framework's TPU server or
    any vLLM-style endpoint) — pages fan out over a thread pool exactly like
    the reference (``parser.py:286-290``).
  * in-process (``use_local=True``, alias ``use_hf=True``): the port's
    InferenceEngine in this process; serial like the reference's HF path.
"""

from __future__ import annotations

import json
import os
from multiprocessing.pool import ThreadPool
from typing import List, Optional

from dots_ocr_tpu_torch.client.inference import inference_with_server
from dots_ocr_tpu_torch.ingest.pdf import load_images_from_pdf, upsample_image_to_dpi
from dots_ocr_tpu_torch.utils.boxes import post_process_output, pre_process_bboxes
from dots_ocr_tpu_torch.utils.consts import MAX_PIXELS, MIN_PIXELS, image_extensions
from dots_ocr_tpu_torch.utils.image_io import fetch_image
from dots_ocr_tpu_torch.utils.markdown import layoutjson2md
from dots_ocr_tpu_torch.utils.prompts import dict_promptmode_to_prompt
from dots_ocr_tpu_torch.utils.resize import smart_resize
from dots_ocr_tpu_torch.utils.visualize import draw_layout_on_image

LAYOUT_PROMPT_MODES = (
    "prompt_layout_all_en",
    "prompt_layout_only_en",
    "prompt_grounding_ocr",
)


class DotsOCRParser:
    """Parse image or PDF files into layout JSON / markdown artifacts."""

    def __init__(
        self,
        protocol: str = "http",
        ip: str = "localhost",
        port: int = 8000,
        model_name: str = "model",
        temperature: float = 0.1,
        top_p: float = 1.0,
        max_completion_tokens: int = 16384,
        num_thread: int = 64,
        dpi: int = 200,
        output_dir: str = "./output",
        min_pixels: Optional[int] = None,
        max_pixels: Optional[int] = None,
        use_hf: bool = False,
        use_local: bool = False,
        engine=None,
        seed: Optional[int] = None,
        device: str = "cuda",
    ):
        self.dpi = dpi
        self.device = device
        self.protocol = protocol
        self.ip = ip
        self.port = port
        self.model_name = model_name
        self.temperature = temperature
        self.top_p = top_p
        # Reproducible eval sweeps: page i of a parse uses seed + i (the
        # serving engine's position-keyed chains make each page's sampled
        # stream bit-stable under server-side co-batching). None = off.
        self.seed = seed
        self.max_completion_tokens = max_completion_tokens
        self.num_thread = num_thread
        self.output_dir = output_dir
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels

        # use_hf kept as a compatibility alias for the reference's in-process
        # mode; both select the local engine.
        self.use_local = use_local or use_hf or engine is not None
        self._engine = engine
        if self.use_local and self._engine is None:
            self._engine = self._load_local_engine()
        assert self.min_pixels is None or self.min_pixels >= MIN_PIXELS
        assert self.max_pixels is None or self.max_pixels <= MAX_PIXELS

    # ------------------------------------------------------------------

    def _load_local_engine(self):
        from dots_ocr_tpu_torch.engine.engine import InferenceEngine

        model_path = os.environ.get("DOTS_OCR_WEIGHTS", "./weights/DotsOCR")
        if os.path.isdir(model_path):
            return InferenceEngine.from_pretrained(model_path, device=self.device)
        raise FileNotFoundError(
            f"local engine needs a checkpoint at {model_path} "
            "(set DOTS_OCR_WEIGHTS) — or pass engine= explicitly"
        )

    def _inference(self, image, prompt: str, temperature: Optional[float] = None,
                   page_no: int = 0):
        temperature = self.temperature if temperature is None else temperature
        seed = None if self.seed is None else self.seed + page_no
        if self.use_local:
            return self._engine.generate_one(
                prompt,
                images=[image],
                temperature=temperature,
                top_p=self.top_p,
                max_new_tokens=self.max_completion_tokens,
                min_pixels=self.min_pixels,
                max_pixels=self.max_pixels,
                seed=seed,
            )
        return inference_with_server(
            image,
            prompt,
            protocol=self.protocol,
            ip=self.ip,
            port=self.port,
            temperature=temperature,
            top_p=self.top_p,
            max_completion_tokens=self.max_completion_tokens,
            model_name=self.model_name,
            seed=seed,
        )

    def get_prompt(
        self,
        prompt_mode: str,
        bbox=None,
        origin_image=None,
        image=None,
        min_pixels=None,
        max_pixels=None,
        custom_prompt: Optional[str] = None,
    ) -> str:
        if custom_prompt is not None:
            return custom_prompt
        prompt = dict_promptmode_to_prompt[prompt_mode]
        if prompt_mode == "prompt_grounding_ocr":
            assert bbox is not None
            bboxes = [bbox]
            bbox = pre_process_bboxes(
                origin_image,
                bboxes,
                input_width=image.width,
                input_height=image.height,
                min_pixels=min_pixels,
                max_pixels=max_pixels,
            )[0]
            prompt = prompt + str(bbox)
        return prompt

    # ------------------------------------------------------------------

    def _parse_single_image(
        self,
        origin_image,
        prompt_mode: str,
        save_dir: str,
        save_name: str,
        source: str = "image",
        page_idx: int = 0,
        bbox=None,
        fitz_preprocess: bool = False,
        custom_prompt: Optional[str] = None,
        temperature: Optional[float] = None,
        response: Optional[str] = None,
        resized_image=None,
    ) -> dict:
        """``response``/``resized_image``: a model response (and the
        model-input image it was generated from) produced ahead of time —
        the batched local-PDF path runs all pages through the continuous
        engine at once, then funnels each page back through this method
        for the identical post-processing/artifact pipeline."""
        min_pixels, max_pixels = self.min_pixels, self.max_pixels
        if prompt_mode == "prompt_grounding_ocr":
            min_pixels = min_pixels or MIN_PIXELS
            max_pixels = max_pixels or MAX_PIXELS
        if min_pixels is not None:
            assert min_pixels >= MIN_PIXELS, f"min_pixels should >= {MIN_PIXELS}"
        if max_pixels is not None:
            assert max_pixels <= MAX_PIXELS, f"max_pixels should <= {MAX_PIXELS}"

        if resized_image is not None:
            image = resized_image
        elif source == "image" and fitz_preprocess:
            image = upsample_image_to_dpi(origin_image, target_dpi=self.dpi)
            image = fetch_image(image, min_pixels=min_pixels, max_pixels=max_pixels)
        else:
            image = fetch_image(
                origin_image, min_pixels=min_pixels, max_pixels=max_pixels
            )
        input_height, input_width = smart_resize(image.height, image.width)
        if response is None:
            prompt = self.get_prompt(
                prompt_mode,
                bbox,
                origin_image,
                image,
                min_pixels=min_pixels,
                max_pixels=max_pixels,
                custom_prompt=custom_prompt,
            )
            response = self._inference(
                image, prompt, temperature=temperature, page_no=page_idx
            )

        result = {
            "page_no": page_idx,
            "input_height": input_height,
            "input_width": input_width,
        }
        if source == "pdf":
            save_name = f"{save_name}_page_{page_idx}"

        if prompt_mode in LAYOUT_PROMPT_MODES and custom_prompt is None:
            cells, filtered = post_process_output(
                response,
                prompt_mode,
                origin_image,
                image,
                min_pixels=min_pixels,
                max_pixels=max_pixels,
            )
            if filtered and prompt_mode != "prompt_layout_only_en":
                # Raw-response fallback: salvaged text only.
                json_file_path = os.path.join(save_dir, f"{save_name}.json")
                with open(json_file_path, "w", encoding="utf-8") as w:
                    json.dump(response, w, ensure_ascii=False)
                image_layout_path = os.path.join(save_dir, f"{save_name}.jpg")
                origin_image.save(image_layout_path)
                md_file_path = os.path.join(save_dir, f"{save_name}.md")
                with open(md_file_path, "w", encoding="utf-8") as f:
                    f.write(cells)
                result.update(
                    {
                        "layout_info_path": json_file_path,
                        "layout_image_path": image_layout_path,
                        "md_content_path": md_file_path,
                        "filtered": True,
                    }
                )
            else:
                try:
                    image_with_layout = draw_layout_on_image(origin_image, cells)
                except Exception as e:  # noqa: BLE001
                    print(f"Error drawing layout on image: {e}")
                    image_with_layout = origin_image

                json_file_path = os.path.join(save_dir, f"{save_name}.json")
                with open(json_file_path, "w", encoding="utf-8") as w:
                    json.dump(cells, w, ensure_ascii=False)
                image_layout_path = os.path.join(save_dir, f"{save_name}.jpg")
                image_with_layout.save(image_layout_path)
                result.update(
                    {
                        "layout_info_path": json_file_path,
                        "layout_image_path": image_layout_path,
                    }
                )
                if prompt_mode != "prompt_layout_only_en":
                    md_content = layoutjson2md(origin_image, cells, text_key="text")
                    md_content_no_hf = layoutjson2md(
                        origin_image, cells, text_key="text", no_page_hf=True
                    )
                    md_file_path = os.path.join(save_dir, f"{save_name}.md")
                    with open(md_file_path, "w", encoding="utf-8") as f:
                        f.write(md_content)
                    md_nohf_file_path = os.path.join(save_dir, f"{save_name}_nohf.md")
                    with open(md_nohf_file_path, "w", encoding="utf-8") as f:
                        f.write(md_content_no_hf)
                    result.update(
                        {
                            "md_content_path": md_file_path,
                            "md_content_nohf_path": md_nohf_file_path,
                        }
                    )
        else:
            image_layout_path = os.path.join(save_dir, f"{save_name}.jpg")
            origin_image.save(image_layout_path)
            md_file_path = os.path.join(save_dir, f"{save_name}.md")
            with open(md_file_path, "w", encoding="utf-8") as f:
                f.write(response if response is not None else "")
            result.update(
                {
                    "layout_image_path": image_layout_path,
                    "md_content_path": md_file_path,
                }
            )
        return result

    # ------------------------------------------------------------------

    def parse_image(
        self,
        input_path,
        filename: str,
        prompt_mode: str,
        save_dir: str,
        bbox=None,
        fitz_preprocess: bool = False,
        custom_prompt: Optional[str] = None,
        temperature: Optional[float] = None,
    ) -> List[dict]:
        origin_image = fetch_image(input_path)
        result = self._parse_single_image(
            origin_image,
            prompt_mode,
            save_dir,
            filename,
            source="image",
            bbox=bbox,
            fitz_preprocess=fitz_preprocess,
            custom_prompt=custom_prompt,
            temperature=temperature,
        )
        result["file_path"] = input_path if isinstance(input_path, str) else filename
        return [result]

    def parse_pdf(
        self,
        input_path: str,
        filename: str,
        prompt_mode: str,
        save_dir: str,
        custom_prompt: Optional[str] = None,
        temperature: Optional[float] = None,
    ) -> List[dict]:
        print(f"loading pdf: {input_path}")
        images_origin = load_images_from_pdf(input_path, dpi=self.dpi)
        total_pages = len(images_origin)
        tasks = [
            {
                "origin_image": image,
                "prompt_mode": prompt_mode,
                "save_dir": save_dir,
                "save_name": filename,
                "source": "pdf",
                "page_idx": i,
                "custom_prompt": custom_prompt,
                "temperature": temperature,
            }
            for i, image in enumerate(images_origin)
        ]

        # Local continuous engine: submit every page at once and let the
        # scheduler's continuous batching overlap encoders/prefills/decodes
        # across pages — the serial per-page loop (the reference's forced
        # num_thread=1 HF path, /root/reference/dots_ocr/parser.py:279-280)
        # leaves the chip idle between pages and runs ~3x slower on
        # multi-page PDFs (PERF.md r5, multi_page_pdf).
        if (
            self.use_local
            and total_pages > 1
            and hasattr(self._engine, "submit")
        ):
            print(
                f"Parsing PDF with {total_pages} pages via the local "
                "continuous-batching engine..."
            )
            results = self._parse_pdf_local_batched(tasks)
            results.sort(key=lambda x: x["page_no"])
            for r in results:
                r["file_path"] = input_path
            return results

        num_thread = 1 if self.use_local else min(total_pages, self.num_thread)
        print(f"Parsing PDF with {total_pages} pages using {num_thread} threads...")

        results: List[dict] = []
        if num_thread <= 1:
            for task in tasks:
                results.append(self._parse_single_image(**task))
        else:
            with ThreadPool(num_thread) as pool:
                for result in pool.imap_unordered(
                    lambda kw: self._parse_single_image(**kw), tasks
                ):
                    results.append(result)

        results.sort(key=lambda x: x["page_no"])
        for r in results:
            r["file_path"] = input_path
        return results

    def _parse_pdf_local_batched(self, tasks: List[dict]) -> List[dict]:
        """Run every page of a PDF through the local continuous engine in
        one batch (encoder admission, chunked prefill, and decode overlap
        across pages), then per-page post-processing via
        ``_parse_single_image(response=...)``. Sampling matches the serial
        path bit-for-bit: seeded parses pass ``seed + page_no`` per
        request (the engine reseeds its chain before each submit exactly
        as ``generate_one(seed=...)`` does), unseeded parses draw the same
        chain keys in the same order."""
        images, prompts = [], []
        for t in tasks:
            img = fetch_image(
                t["origin_image"],
                min_pixels=self.min_pixels,
                max_pixels=self.max_pixels,
            )
            images.append(img)
            prompts.append(
                self.get_prompt(
                    t["prompt_mode"],
                    None,
                    t["origin_image"],
                    img,
                    min_pixels=self.min_pixels,
                    max_pixels=self.max_pixels,
                    custom_prompt=t["custom_prompt"],
                )
            )
        temperature = tasks[0]["temperature"]
        temperature = self.temperature if temperature is None else temperature
        seeds = (
            None
            if self.seed is None
            else [self.seed + t["page_idx"] for t in tasks]
        )
        responses = self._engine.generate_batch(
            prompts,
            [[img] for img in images],
            temperature=temperature,
            top_p=self.top_p,
            max_new_tokens=self.max_completion_tokens,
            min_pixels=self.min_pixels,
            max_pixels=self.max_pixels,
            seed=seeds,
        )
        return [
            self._parse_single_image(
                **t, response=resp, resized_image=img
            )
            for t, resp, img in zip(tasks, responses, images)
        ]

    def parse_file(
        self,
        input_path: str,
        output_dir: str = "",
        prompt_mode: str = "prompt_layout_all_en",
        bbox=None,
        fitz_preprocess: bool = False,
        custom_prompt: Optional[str] = None,
        temperature: Optional[float] = None,
    ) -> List[dict]:
        output_dir = output_dir or self.output_dir
        output_dir = os.path.abspath(output_dir)
        filename, file_ext = os.path.splitext(os.path.basename(input_path))
        save_dir = os.path.join(output_dir, filename)
        os.makedirs(save_dir, exist_ok=True)

        if file_ext == ".pdf":
            results = self.parse_pdf(
                input_path, filename, prompt_mode, save_dir,
                custom_prompt=custom_prompt, temperature=temperature,
            )
        elif file_ext in image_extensions:
            results = self.parse_image(
                input_path,
                filename,
                prompt_mode,
                save_dir,
                bbox=bbox,
                fitz_preprocess=fitz_preprocess,
                custom_prompt=custom_prompt,
                temperature=temperature,
            )
        else:
            raise ValueError(
                f"file extension {file_ext} not supported, supported extensions "
                f"are {image_extensions} and pdf"
            )

        print(f"Parsing finished, results saving to {save_dir}")
        with open(
            os.path.join(output_dir, os.path.basename(filename) + ".jsonl"),
            "w",
            encoding="utf-8",
        ) as w:
            for result in results:
                w.write(json.dumps(result, ensure_ascii=False) + "\n")
        return results


# Newer-demo alias (the renamed dots.mocr repo's class name, referenced by
# demo/demo_gradio.py:145).
DotsMOCRParser = DotsOCRParser
