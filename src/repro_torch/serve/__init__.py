"""Serving on the port: continuous batching over a fixed slot grid."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
