"""dots_ocr_tpu_torch: the PyTorch/CUDA port of ``dots_ocr_tpu`` for one
NVIDIA H100.

The layout mirrors the JAX package (``models/``, ``ops/``, ``engine/``,
``serve/``) so each module's counterpart is found by name; public functions
keep the JAX tensor layouts (``q [B, T, H, D]``, paged pools
``[KV, N_slots, D]`` per layer, linear kernels ``[in, out]``) so the parity
tests compare like with like. Every Pallas kernel of the JAX package (flash
attention, the multi-query and the v1 paged decode attention, the window
attention, the int4 matmul) is hand-written CUDA C++ for ``sm_90a`` in
``csrc/``, built with ``nvcc`` at first use.

This package imports ``torch`` and never ``jax``, and nothing of the JAX
package: it carries its own copies of the jax-free host modules it needs
(the OpenAI server, the engine worker, the tokenizers, the chat template,
the repetition guard, ``utils`` and the native patchifier).
"""

import torch

# float32 matmuls and convolutions run in full float32. TF32 keeps ~10
# mantissa bits; the JAX reference runs its float32 parity paths at
# "highest" precision, and a TF32 matmul on the card would make the port
# disagree with it by ~1e-3 relative for reasons unrelated to the code.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
