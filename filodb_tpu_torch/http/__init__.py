"""HTTP API edge of the port (the counterpart of ``filodb_tpu.http``)."""

from filodb_tpu_torch.http.server import FiloHttpServer

__all__ = ["FiloHttpServer"]
