"""Share of the window's batches whose shard the trainer's data pipeline
found in the chosen host's cache (``DiffusionDataPipeline.stats`` hits
over hits and misses, their change over the window), in %."""


def read(obs):
    c = obs.counters
    total = c.get("hits", 0) + c.get("misses", 0)
    return 100.0 * c["hits"] / total if total else None
