"""Model facade: build the right model class for a config."""

from __future__ import annotations

from repro_torch.models.lm import LM


def build_model(cfg, *, device=None, generator=None, seed: int = 0) -> LM:
    """The model of ``cfg`` with seeded random parameters on ``device``.

    ``device`` defaults to the CUDA card.  Encoder-decoder families raise
    ``NotImplementedError``: they come with a later slice of the port.
    """
    if cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model comes with a later slice"
        )
    return LM(cfg, device=device, generator=generator, seed=seed)
