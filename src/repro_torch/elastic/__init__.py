from repro_torch.core.backend import LiveBackend
from repro_torch.elastic.runtime import BFTrainerRuntime, ManagedTrainer, \
    RuntimeReport
from repro_torch.elastic.trainer import ElasticTrainer, TrainMetrics

__all__ = ["BFTrainerRuntime", "LiveBackend", "ManagedTrainer",
           "RuntimeReport", "ElasticTrainer", "TrainMetrics"]
