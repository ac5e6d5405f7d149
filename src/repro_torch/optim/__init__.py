from .adamw import (
    AdamWConfig,
    adamw8bit_init,
    adamw8bit_update,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "adamw8bit_init",
    "adamw8bit_update", "cosine_schedule", "global_norm",
]
