"""The standalone server of the port (the counterpart of
``filodb_tpu.standalone``): ``python -m
filodb_tpu_torch.standalone.server``."""
