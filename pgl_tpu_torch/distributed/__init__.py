"""Distributed host-side graph service and parameter server (port of
``pgl_tpu/distributed``; reference: ``pgl/distributed/``). numpy, sockets
and the port's C++ host kernels: nothing here runs on the card."""

from . import helper
from .dist_graph import (DistGraphServer, DistGraphClient,
                         stream_shuffle_generator)
from .rpc import RpcServer, RpcClient

__all__ = ["helper", "DistGraphServer", "DistGraphClient",
           "stream_shuffle_generator", "RpcServer", "RpcClient"]
