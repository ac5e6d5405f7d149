from .pipeline import (
    DiffusionDataPipeline,
    HostShardCache,
    ObjectStoreEmulator,
    PipelineConfig,
    PrefetchingPipeline,
    ShardSpec,
)

__all__ = [
    "DiffusionDataPipeline", "HostShardCache", "ObjectStoreEmulator",
    "PipelineConfig", "PrefetchingPipeline", "ShardSpec",
]
