"""Resolution and file-type contract constants.

Parity with the reference contract in ``dots_ocr/utils/consts.py:1-5``:
factor 28 = vision patch 14 x spatial-merge 2; the pixel bounds clamp every
input image onto a 28-multiple grid between 4 merged tokens (56x56 px) and
~14.4k merged tokens (11.3 MP).
"""

IMAGE_FACTOR = 28
MIN_PIXELS = 3136
MAX_PIXELS = 11289600

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png"}

# Back-compat alias matching the reference's public name.
image_extensions = IMAGE_EXTENSIONS
