"""Command-line interface: ``python -m dots_ocr_tpu_torch <file> --prompt ...``

The PyTorch port's copy of ``dots_ocr_tpu.cli``. Flag-compatible with the
reference CLI (``dots_ocr/parser.py:326-436``), plus ``--use_local/--weights``
for the in-process engine, ``--platform`` (the torch device of that engine:
``cuda``, the default, or ``cpu``) and ``--custom_prompt`` (the newer-demo
extension).
"""

from __future__ import annotations

import argparse
import os

from dots_ocr_tpu_torch.parser import DotsOCRParser
from dots_ocr_tpu_torch.utils.prompts import dict_promptmode_to_prompt


def build_arg_parser() -> argparse.ArgumentParser:
    prompts = list(dict_promptmode_to_prompt.keys())
    parser = argparse.ArgumentParser(
        description="dots.ocr (PyTorch port) multilingual document layout parser",
    )
    parser.add_argument("input_path", type=str, help="Input PDF/image file path")
    parser.add_argument(
        "--output", type=str, default="./output", help="Output directory"
    )
    parser.add_argument(
        "--prompt",
        choices=prompts,
        type=str,
        default="prompt_layout_all_en",
        help="prompt mode selecting the task",
    )
    parser.add_argument(
        "--custom_prompt", type=str, default=None,
        help="free-form prompt overriding --prompt (raw response saved as .md)",
    )
    parser.add_argument(
        "--bbox", type=int, nargs=4, metavar=("x1", "y1", "x2", "y2"),
        help="bbox for prompt_grounding_ocr",
    )
    parser.add_argument("--protocol", type=str, choices=["http", "https"], default="http")
    parser.add_argument("--ip", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model_name", type=str, default="model")
    parser.add_argument("--temperature", type=float, default=0.1)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument(
        "--seed", type=int, default=None,
        help="reproducible sampled parses: page i uses seed + i",
    )
    parser.add_argument("--dpi", type=int, default=200)
    parser.add_argument("--max_completion_tokens", type=int, default=16384)
    parser.add_argument("--num_thread", type=int, default=16)
    parser.add_argument(
        "--no_fitz_preprocess", action="store_true",
        help="disable the 200-dpi re-raster preprocessing for image inputs",
    )
    parser.add_argument("--min_pixels", type=int, default=None)
    parser.add_argument("--max_pixels", type=int, default=None)
    parser.add_argument(
        "--use_local", action="store_true",
        help="run the engine in-process instead of calling a server",
    )
    parser.add_argument(
        "--use_hf", action="store_true",
        help="compatibility alias for --use_local",
    )
    parser.add_argument(
        "--weights", type=str, default=None,
        help="checkpoint dir for --use_local (else $DOTS_OCR_WEIGHTS)",
    )
    parser.add_argument(
        "--platform", type=str, default=os.environ.get("DOTS_OCR_PLATFORM", "cuda"),
        help="torch device of the --use_local engine: 'cuda' (default) or 'cpu'",
    )
    return parser


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    if args.weights:
        os.environ["DOTS_OCR_WEIGHTS"] = args.weights

    parser = DotsOCRParser(
        protocol=args.protocol,
        ip=args.ip,
        port=args.port,
        model_name=args.model_name,
        temperature=args.temperature,
        top_p=args.top_p,
        seed=args.seed,
        max_completion_tokens=args.max_completion_tokens,
        num_thread=args.num_thread,
        dpi=args.dpi,
        output_dir=args.output,
        min_pixels=args.min_pixels,
        max_pixels=args.max_pixels,
        use_local=args.use_local or args.use_hf,
        device=args.platform,
    )
    fitz_preprocess = not args.no_fitz_preprocess
    if fitz_preprocess:
        print("Using fitz preprocess for image input, check the change of the image pixels")
    return parser.parse_file(
        args.input_path,
        prompt_mode=args.prompt,
        bbox=args.bbox,
        fitz_preprocess=fitz_preprocess,
        custom_prompt=args.custom_prompt,
        temperature=args.temperature,
    )


if __name__ == "__main__":
    main()
