"""Tensor-parallel serving and (data, model)-parallel training over
``torch.distributed`` (port of ``dots_ocr_tpu.parallel``): the process
groups and their layout (``distributed``) and the per-rank parameter and
batch shards (``sharding``)."""
