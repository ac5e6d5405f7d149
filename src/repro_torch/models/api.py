"""Model API of the port: init / caches / prefill and decode steps.

A port of the decoder-only half of the reference's ``models/api.py``;
encoder-decoder configs raise (ROADMAP C4).  Params are drawn on the target
device from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from . import lm


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.encoder_layers > 0


def _require_decoder_only(cfg: ArchConfig) -> None:
    if is_encdec(cfg):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models (ROADMAP C4) are not ported")


def attn_chunk(seq_len: int) -> int:
    if seq_len >= 1 << 15:
        return 512
    return min(1024, max(128, seq_len))


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda", seed: int = 0):
    """Random params from ``gen`` (default: a generator on ``device`` seeded
    with ``seed``); they live on the generator's device."""
    _require_decoder_only(cfg)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return lm.lm_init(gen, cfg)


def cache_init(cfg: ArchConfig, batch: int, cap: int, device="cuda"):
    _require_decoder_only(cfg)
    return lm.lm_cache_init(cfg, batch, cap, device)


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig):
    _require_decoder_only(cfg)
    return functools.partial(lm.lm_prefill, cfg=cfg, chunk=attn_chunk(shape.seq_len))


def make_decode_step(cfg: ArchConfig):
    _require_decoder_only(cfg)
    return functools.partial(lm.lm_decode, cfg=cfg)
