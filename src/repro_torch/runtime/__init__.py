"""Runtime of the port: the copied router/admission/chaos/fault/elastic
planes, gradient compression, the torch serving loop and the training
loop."""

from .compression import (
    compressed_psum,
    init_error_state,
    int8_dequantize,
    int8_quantize,
    topk_compress,
)
from .elastic import ElasticController, ScaleEvent
from .fault_tolerance import (
    FailureInjector,
    HeartbeatMonitor,
    RecoveryActions,
    recover,
)
from .router import (
    Assignment,
    CacheAffinityRouter,
    ReplicaStore,
    RoutedRequest,
    RouterStats,
)
from .serve_loop import DiffusionServer, Replica, Request, ServeStats
from .train_loop import TrainConfig, Trainer, TrainResult

__all__ = [
    "compressed_psum", "init_error_state", "int8_dequantize", "int8_quantize",
    "topk_compress",
    "ElasticController", "ScaleEvent",
    "FailureInjector", "HeartbeatMonitor", "RecoveryActions", "recover",
    "Assignment", "CacheAffinityRouter", "ReplicaStore", "RoutedRequest",
    "RouterStats",
    "DiffusionServer", "Replica", "Request", "ServeStats",
    "TrainConfig", "Trainer", "TrainResult",
]
