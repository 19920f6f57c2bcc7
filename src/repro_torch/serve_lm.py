"""Serve any registered architecture: batched prefill, then greedy decode.

The port's counterpart of ``examples/serve_lm.py``: the same flags, the same
greedy argmax over the padded logits and the same prefill-then-decode loop
with one position for the whole batch.  Attention runs through the
hand-written flash kernel (prefill) and decode kernel (every step); a
hybrid model's (zamba2's) Mamba-2 layers run the hand-written SSD scan at
prefill and an O(1) recurrence at each decode step; an ssm model's
(xlstm's) mLSTM layers run the hand-written mLSTM scan at prefill and an
O(1) recurrence at each decode step.  MLA (minicpm3) and the MoE FFN
(granite-moe, grok-1) are plain einsum, as in the reference.  The VLM
(qwen2-vl) takes ``--vision-tokens`` stub vision embeddings before the
prompt; the encoder-decoder (seamless-m4t) encodes ``--source-frames`` stub
frame embeddings and cross-attends to them at every step.

    python -m repro_torch.serve_lm --arch olmo-1b                # on the card
    python -m repro_torch.serve_lm --arch olmo-1b --device cpu   # on the host
    python -m repro_torch.serve_lm --arch zamba2-1.2b --full \\
        --prompt-len 1024 --new-tokens 32                        # published width
    python -m repro_torch.serve_lm --arch seamless-m4t-medium --device cpu

Without ``--full`` the config is the reduced smoke variant.  Parameters,
prompts and the stub embeddings are random, drawn from ``--seed`` by
``torch.Generator``s on the device.  Without a CUDA card the default device
raises; pass ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import torch

from repro_torch.configs import registry
from repro_torch.models.lm import resolve_device
from repro_torch.models.model import build_model


@dataclass
class ServeResult:
    """What one batch of prompts produced, and how long it took."""

    tokens: torch.Tensor  # (B, new_tokens) greedy tokens
    prefill_logits: torch.Tensor  # (B, 1, vocab_padded) f32
    decode_logits: list = field(default_factory=list)  # per step (B, 1, V)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    start: int = 0  # positions the prefill filled; decode step t writes start + t


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def serve(model, prompts: torch.Tensor, new_tokens: int, inputs=None) -> ServeResult:
    """Prefill ``prompts`` (B, P) and decode ``new_tokens`` greedy tokens.

    ``inputs`` adds the stub embeddings to the batch: ``vision_embeds``
    (B, v, d), a prefix of v positions before the prompt, or ``frames``
    (B, S_src, d) for the encoder.  The caches hold ``v + P + new_tokens``
    positions; decode step ``t`` writes position ``v + P + t``.  Host times
    end in a device synchronize.
    """
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    batch = {"tokens": prompts, **(inputs or {})}
    device = prompts.device
    start = prompts.shape[1]
    if "vision_embeds" in batch:
        start += batch["vision_embeds"].shape[1]
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = model.prefill(batch, s_max=start + new_tokens)
    tok = _greedy(logits)
    _sync(device)
    res = ServeResult(tokens=tok, prefill_logits=logits, start=start)
    res.prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for t in range(new_tokens - 1):
        logits, caches = model.decode(caches, tok, start + t)
        tok = _greedy(logits)
        res.decode_logits.append(logits)
        out.append(tok)
    _sync(device)
    res.decode_s = time.perf_counter() - t0
    res.tokens = torch.cat(out, dim=1)
    return res


def stub_inputs(cfg, batch: int, gen: torch.Generator, *, vision_tokens: int,
                source_frames: int) -> dict:
    """The stub frontends' embeddings for ``cfg``'s family, as the reference
    example draws them: ``0.01·N(0,1)`` vision embeddings (B, v, d) for a
    VLM, ``0.1·N(0,1)`` frames (B, S_src, d) for an encoder-decoder."""
    if cfg.family == "vlm":
        key, n, scale = "vision_embeds", vision_tokens, 0.01
    elif cfg.family in ("encdec", "audio"):
        key, n, scale = "frames", source_frames, 0.1
    else:
        return {}
    x = torch.randn((batch, n, cfg.d_model), generator=gen, device=gen.device)
    return {key: scale * x}


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b", choices=list(registry.ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--full", action="store_true", help="the published config, not .reduced()"
    )
    ap.add_argument("--vision-tokens", type=int, default=16,
                    help="stub vision tokens before the prompt (vlm)")
    ap.add_argument("--source-frames", type=int, default=16,
                    help="stub source frames for the encoder (encdec / audio)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = build_model(cfg, device=device, seed=args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=device
    )
    inputs = stub_inputs(cfg, args.batch, gen, vision_tokens=args.vision_tokens,
                         source_frames=args.source_frames)
    res = serve(model, prompts, args.new_tokens, inputs)
    b, n = args.batch, args.new_tokens - 1
    print(f"prefill {b}x{args.prompt_len}: {res.prefill_s:.2f}s")
    rate = b * n / res.decode_s if res.decode_s > 0 else float("inf")
    print(f"decoded {n} tokens/seq in {res.decode_s:.2f}s ({rate:.1f} tok/s total)")
    print("sample:", res.tokens[0].tolist())
    last = res.decode_logits[-1] if res.decode_logits else res.prefill_logits
    if not bool(torch.isfinite(last).all()):
        raise RuntimeError("non-finite logits")
    return res


if __name__ == "__main__":
    main()
