"""Deterministic, resumable synthetic data pipeline.

The port of ``repro/data/pipeline.py``.  Batches are a pure function of
``(seed, step, process_index)``: a restart resumes mid-run with no state
beyond the step counter (the checkpoint stores it).  Each process builds
only its slice of the global batch.

The token stream is Zipf(a) by rank with a Markov drift, as in the
reference, so the LM loss has learnable structure.  The bits are drawn
with NumPy from ``SeedSequence((seed, step, process_index))``, so they
differ from ``jax.random``'s; the distribution is the same.  Batches are
built on the host as int64 CPU tensors; the trainer moves them to its
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticLM:
    """Batch factory: batch(step) -> {tokens, labels}, pure in (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-ish unigram distribution (stable across runs), rounded to f32
        # as the reference holds it
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.probs = (probs / probs.sum()).astype(np.float32)
        cdf = np.cumsum(self.probs.astype(np.float64))
        self._cdf = cdf / cdf[-1]

    def batch(self, step: int, *, process_index: int = 0,
              process_count: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % process_count:
            raise ValueError(
                f"global batch {cfg.global_batch} does not split over "
                f"{process_count} processes"
            )
        shape = (cfg.global_batch // process_count, cfg.seq_len)
        rng = np.random.default_rng(
            np.random.SeedSequence((cfg.seed, step, process_index))
        )
        base = np.searchsorted(self._cdf, rng.random(shape), side="right")
        base = np.minimum(base, cfg.vocab - 1)
        # Markov drift: about half the positions copy the previous token
        # plus one, giving next-token structure the model can learn
        shift = np.roll(base, 1, axis=1)
        mix = rng.random(shape) < 0.5
        tokens = torch.from_numpy(np.where(mix, (shift + 1) % cfg.vocab, base))
        return {"tokens": tokens, "labels": tokens.clone()}

    def global_batch_on(self, step: int, mesh, plan) -> dict:
        """The global batch of ``step`` as DTensors on ``mesh`` (a
        DeviceMesh), sharded by ``plan`` over ``("batch", "seq")``: every
        rank draws the same global batch and keeps its shard, on the mesh's
        device."""
        from torch.distributed.tensor import distribute_tensor

        placements = plan.placements(mesh, "batch", "seq")
        return {k: distribute_tensor(v.to(mesh.device_type), mesh, placements,
                                     src_data_rank=None)
                for k, v in self.batch(step).items()}
