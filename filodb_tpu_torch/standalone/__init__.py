"""The standalone server of the port and its process-sharded serving
supervisor (the counterpart of ``filodb_tpu.standalone``): ``python -m
filodb_tpu_torch.standalone.server`` and ``python -m
filodb_tpu_torch.standalone.supervisor``.

Imports are lazy (PEP 562): the supervisor process never imports the
query stack (numpy, torch); it only starts, monitors and aggregates
workers, so pulling :class:`Supervisor` must not drag
:class:`FiloServer`'s dependency tree in.
"""


def __getattr__(name):
    if name == "FiloServer":
        from filodb_tpu_torch.standalone.server import FiloServer
        return FiloServer
    if name == "Supervisor":
        from filodb_tpu_torch.standalone.supervisor import Supervisor
        return Supervisor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["FiloServer", "Supervisor"]
