"""Runtime of the port: the serving loop and the trainer."""
from repro_torch.runtime.serving import Request, Server
from repro_torch.runtime.trainer import ElasticTrainer, TrainerConfig

__all__ = ["ElasticTrainer", "Request", "Server", "TrainerConfig"]
