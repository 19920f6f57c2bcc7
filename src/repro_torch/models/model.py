"""Model facade: build the right model class for a config."""

from __future__ import annotations

from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM


def build_model(cfg, *, device=None, generator=None, seed: int = 0):
    """The model of ``cfg`` (an ``EncDec`` for the encoder-decoder
    families, else an ``LM``) with seeded random parameters on ``device``.

    ``device`` defaults to the CUDA card.
    """
    cls = EncDec if cfg.family in ("encdec", "audio") else LM
    return cls(cfg, device=device, generator=generator, seed=seed)
