"""The scorer seam of the port: the Go plugin's Sync, Score and Assign RPCs
served from a device-resident snapshot.

Counterpart of ``koordinator_tpu/bridge``.  ``wire.py`` is the protobuf
wire codec (no protobuf runtime), ``state.py`` the resident snapshot,
``coalesce.py`` the pipelined coalescing dispatcher, ``server.py`` the
``ScorerServicer`` and its gRPC transport, ``udsserver.py`` the raw
length-prefixed UDS transport, ``client.py`` the delta-encoding
``ScorerClient`` over either transport, ``plugin_sim.py`` the executable
spec of the Go plugin.  Nothing here imports the protobuf runtime; ``grpc``
is imported only by the two functions that build gRPC transports
(``server.make_server`` and ``client._grpc_channel``).
"""
