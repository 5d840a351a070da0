"""Task-prompt registry.

The model is task-switched purely by prompt (reference ``dots_ocr/utils/prompts.py:1-46``).
The prompt strings are part of the model's trained API contract and must be
reproduced character-for-character: the checkpoint was fine-tuned on exactly
these strings, so any drift changes model behavior.
"""

dict_promptmode_to_prompt = {
    # prompt_layout_all_en: parse all layout info in json format.
    "prompt_layout_all_en": """Please output the layout information from the PDF image, including each layout element's bbox, its category, and the corresponding text content within the bbox.

1. Bbox format: [x1, y1, x2, y2]

2. Layout Categories: The possible categories are ['Caption', 'Footnote', 'Formula', 'List-item', 'Page-footer', 'Page-header', 'Picture', 'Section-header', 'Table', 'Text', 'Title'].

3. Text Extraction & Formatting Rules:
    - Picture: For the 'Picture' category, the text field should be omitted.
    - Formula: Format its text as LaTeX.
    - Table: Format its text as HTML.
    - All Others (Text, Title, etc.): Format their text as Markdown.

4. Constraints:
    - The output text must be the original text from the image, with no translation.
    - All layout elements must be sorted according to human reading order.

5. Final Output: The entire output must be a single JSON object.
""",

    # prompt_layout_only_en: layout detection without text
    "prompt_layout_only_en": """Please output the layout information from this PDF image, including each layout's bbox and its category. The bbox should be in the format [x1, y1, x2, y2]. The layout categories for the PDF document include ['Caption', 'Footnote', 'Formula', 'List-item', 'Page-footer', 'Page-header', 'Picture', 'Section-header', 'Table', 'Text', 'Title']. Do not output the corresponding text. The layout result should be in JSON format.""",

    # prompt_ocr: plain text extraction
    "prompt_ocr": """Extract the text content from this image.""",

    # prompt_grounding_ocr: extract text inside a given bbox (the caller
    # appends the rescaled bbox, see parser.get_prompt)
    "prompt_grounding_ocr": """Extract text from the given bounding box on the image (format: [x1, y1, x2, y2]).\nBounding Box:\n""",

    # prompt_web_parsing: webpage layout to json
    "prompt_web_parsing": """Parsing the layout info of this webpage image with format json:\n""",

    # prompt_scene_spotting: scene-text spotting
    "prompt_scene_spotting": """Detect and recognize the text in the image.""",

    # prompt_image_to_svg: image -> SVG code ({width}/{height} filled by caller)
    "prompt_image_to_svg": """Please generate the SVG code based on the image.viewBox="0 0 {width} {height}\"""",

    # prompt_general: free-form QA (single space on purpose)
    "prompt_general": """ """,
}

# Layout categories recognized by the model, in the order listed in the prompt.
LAYOUT_CATEGORIES = [
    "Caption",
    "Footnote",
    "Formula",
    "List-item",
    "Page-footer",
    "Page-header",
    "Picture",
    "Section-header",
    "Table",
    "Text",
    "Title",
]

# Per-task sampling policy (reference: temperature 0.1 / top_p 1.0 for layout
# and OCR at dots_ocr/parser.py:27-28; temperature 0.9 for SVG generation at
# demo/demo_vllm_svg.py:35 and demo/demo_gradio.py:69-77 — low temperature
# causes repetition loops on long SVG decodes).
PROMPT_TEMPERATURE = {mode: 0.1 for mode in dict_promptmode_to_prompt}
PROMPT_TEMPERATURE["prompt_image_to_svg"] = 0.9

# Per-task fitz re-raster policy mirroring demo/demo_gradio.py:58-66: document
# parsing tasks benefit from the 200-dpi re-raster; scene/web/SVG do not.
PROMPT_FITZ_PREPROCESS = {
    "prompt_layout_all_en": True,
    "prompt_layout_only_en": True,
    "prompt_ocr": True,
    "prompt_grounding_ocr": True,
    "prompt_web_parsing": False,
    "prompt_scene_spotting": False,
    "prompt_image_to_svg": False,
    "prompt_general": False,
}
