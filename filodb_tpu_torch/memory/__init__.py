"""Columnar chunk codecs (copies of ``filodb_tpu.memory``)."""

from filodb_tpu_torch.memory import nibblepack  # noqa: F401
