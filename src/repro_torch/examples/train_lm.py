"""End-to-end example: train a ~100M-parameter LM on the synthetic stream.

The port of ``examples/train_lm.py``: an olmo-family model of 8 layers at
d 768 (12 heads of 64) over the 50304-token vocab, AdamW with the cosine
schedule, deterministic data, asynchronous checkpoints with resume and the
straggler monitor, on one device (the CUDA card unless ``--device`` says
otherwise).  It asserts that the loss falls.

    python -m repro_torch.examples.train_lm --steps 300
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.launch.train import RunConfig, train

ARCH = "olmo-1b-100m"


def register_100m() -> str:
    """Register the ~100M olmo variant (8 layers x d 768 + the 50k vocab)."""
    if ARCH not in registry.ARCHS:
        registry.ARCHS[ARCH] = registry.get("olmo-1b").reduced(
            name=ARCH, n_layers=8, d_model=768, n_heads=12, n_kv_heads=12,
            head_dim=64, d_ff=3072, vocab=50304)
    return ARCH


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: %(default)s)")
    args = ap.parse_args(argv)
    run = RunConfig(arch=register_100m(), reduced=False, steps=args.steps,
                    seq_len=256, global_batch=8, ckpt_every=100,
                    ckpt_dir=args.ckpt_dir, device=args.device)
    losses, mon = train(run)
    n = max(1, len(losses) // 10)
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(losses)} steps; "
          f"{len(mon.flagged)} straggler events")
    if not last < first:
        raise SystemExit("loss should decrease on the synthetic stream")
    return losses, mon


if __name__ == "__main__":
    main()
