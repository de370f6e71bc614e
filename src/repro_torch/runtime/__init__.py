"""Runtime of the port: the serving loop."""
from repro_torch.runtime.serving import Request, Server

__all__ = ["Request", "Server"]
