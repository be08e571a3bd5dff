"""Session protocol v2: the gRPC tunnel at revisions 1-3 (the port of
``gpud_tpu/session/v2/``). Nothing here loads ``grpc`` or ``protobuf`` when
imported, apart from the generated ``session_pb2`` itself."""
