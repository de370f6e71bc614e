"""Runtime of the port: the serving loop, the elastic trainer and the
in-process RMS it talks to."""
from repro_torch.runtime.local_rms import LocalRMS
from repro_torch.runtime.serving import Request, Server
from repro_torch.runtime.trainer import ElasticTrainer, TrainerConfig

__all__ = ["ElasticTrainer", "LocalRMS", "Request", "Server",
           "TrainerConfig"]
