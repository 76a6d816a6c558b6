"""Native (C++) host kernels of the port: ``graph_kernel``, built with g++
on first use and bound with ctypes."""

from . import graph_kernel

__all__ = ["graph_kernel"]
