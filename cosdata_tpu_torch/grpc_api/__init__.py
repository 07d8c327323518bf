"""gRPC API (parity with the reference's feature-gated tonic server,
upstream src/grpc/ + proto/vector_service.proto).

Messages are protoc-generated (`vector_service_pb2`); services are wired
with grpc generic method handlers (the image has no grpc_tools stub
codegen). Regenerate after editing proto/vector_service.proto:

    protoc --python_out=cosdata_tpu_torch/grpc_api -I proto proto/vector_service.proto

Port of ``cosdata_tpu/grpc_api/__init__.py`` (a copy; imports name ``cosdata_tpu_torch``).
"""
