"""Hand-implemented gRPC server reflection (v1alpha).

The reference enables tonic server reflection on its gRPC endpoint
(upstream src/grpc/server.rs:24-44) so grpcurl-class clients can
list/describe services without the vendored proto. The grpcio-reflection
package is absent from this image, so the v1alpha protocol is implemented
directly over the process's default descriptor pool: ~100 LoC of
stream-request dispatch, answering list_services, file_by_filename,
file_containing_symbol and all_extension_numbers_of_type from the
descriptors the generated *_pb2 modules already registered.

Port of ``cosdata_tpu/grpc_api/reflection.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""

from __future__ import annotations

import grpc
from google.protobuf import descriptor_pool

from cosdata_tpu_torch.grpc_api import reflection_v1alpha_pb2 as rpb

SERVICE_NAME = "grpc.reflection.v1alpha.ServerReflection"


def _file_and_deps(pool, fd) -> list[bytes]:
    """Serialized FileDescriptorProto of ``fd`` plus its transitive
    dependencies (reflection clients need the full closure to build the
    schema)."""
    out: list[bytes] = []
    seen: set[str] = set()

    def walk(f):
        if f.name in seen:
            return
        seen.add(f.name)
        for dep in f.dependencies:
            walk(dep)
        proto = f.serialized_pb
        out.append(proto)

    walk(fd)
    return out


class ReflectionServicer:
    """Bidirectional-stream servicer for ServerReflectionInfo."""

    def __init__(self, service_names: list[str]):
        self._names = list(service_names) + [SERVICE_NAME]

    def ServerReflectionInfo(self, request_iterator, context):
        pool = descriptor_pool.Default()
        for req in request_iterator:
            resp = rpb.ServerReflectionResponse(
                valid_host=req.host, original_request=req
            )
            which = req.WhichOneof("message_request")
            try:
                if which == "list_services":
                    resp.list_services_response.service.extend(
                        rpb.ServiceResponse(name=n) for n in self._names
                    )
                elif which == "file_by_filename":
                    fd = pool.FindFileByName(req.file_by_filename)
                    resp.file_descriptor_response.file_descriptor_proto.extend(
                        _file_and_deps(pool, fd)
                    )
                elif which == "file_containing_symbol":
                    fd = pool.FindFileContainingSymbol(
                        req.file_containing_symbol
                    )
                    resp.file_descriptor_response.file_descriptor_proto.extend(
                        _file_and_deps(pool, fd)
                    )
                elif which == "file_containing_extension":
                    ext = req.file_containing_extension
                    desc = pool.FindMessageTypeByName(ext.containing_type)
                    ext_desc = pool.FindExtensionByNumber(
                        desc, ext.extension_number
                    )
                    resp.file_descriptor_response.file_descriptor_proto.extend(
                        _file_and_deps(pool, ext_desc.file)
                    )
                elif which == "all_extension_numbers_of_type":
                    desc = pool.FindMessageTypeByName(
                        req.all_extension_numbers_of_type
                    )
                    nums = [
                        e.number for e in pool.FindAllExtensions(desc)
                    ]
                    resp.all_extension_numbers_response.base_type_name = (
                        desc.full_name
                    )
                    resp.all_extension_numbers_response.extension_number.extend(
                        nums
                    )
                else:
                    resp.error_response.error_code = (
                        grpc.StatusCode.INVALID_ARGUMENT.value[0]
                    )
                    resp.error_response.error_message = (
                        f"unsupported reflection request {which!r}"
                    )
            except KeyError:
                resp.error_response.error_code = (
                    grpc.StatusCode.NOT_FOUND.value[0]
                )
                resp.error_response.error_message = "symbol not found"
            yield resp


def reflection_handler(service_names: list[str]):
    """Generic handler registering ServerReflectionInfo (stream/stream)."""
    impl = ReflectionServicer(service_names)
    rpc = {
        "ServerReflectionInfo": grpc.stream_stream_rpc_method_handler(
            impl.ServerReflectionInfo,
            request_deserializer=rpb.ServerReflectionRequest.FromString,
            response_serializer=rpb.ServerReflectionResponse.SerializeToString,
        )
    }
    return grpc.method_handlers_generic_handler(SERVICE_NAME, rpc)
