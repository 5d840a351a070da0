"""Tensor-parallel serving over ``torch.distributed`` (port of
``dots_ocr_tpu.parallel``): the process group (``distributed``) and the
per-rank parameter shards (``sharding``)."""
