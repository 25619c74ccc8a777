"""gRPC query service of the port (the counterpart of
``filodb_tpu.grpcsvc``): the binary data plane for peer leaf dispatch and
cross-cluster federation (http/PromQLGrpcServer.scala:44;
grpc/src/main/protobuf/query_service.proto, range_vector.proto).

Runs on the real grpcio runtime (persistent HTTP/2 channels, multiplexed
RPCs) with hand-encoded protobuf messages — no codegen; the wire module
builds the same length-delimited field encoding the reference's .proto
files compile to, and sample payloads ride NibblePack (delta-packed
timestamps, XOR-packed doubles), the reference's own chunk codec.
"""

from filodb_tpu_torch.grpcsvc.client import (  # noqa: F401
    GrpcRemoteExec, GrpcShardGroup, PlaneFallbacks)
from filodb_tpu_torch.grpcsvc.server import GrpcQueryServer  # noqa: F401
