#!/usr/bin/env python3
"""How far bf16 takes the recurrent models from float32, on the card.

For each arch (default: zamba2-2.7b and rwkv6-7b, whole, weights drawn
from seed 0): 32 teacher-forced tokens through ``forward`` and
``decode_step`` in bf16 and in a float32 copy of the same weights, each
distance as a share of the float32 forward's largest logit (overall and
every 4th position), the greedy tokens' agreement, and how far the
float32 logits move when the embedding table is perturbed by a relative
2^-9 (one bf16 rounding) and by 1e-6: the stack's amplification of a
rounding of its input.  TF32 is off.  Needs one card::

    PYTHONPATH=src python3 scripts/recurrent_bf16_sensitivity.py [ARCH ...]
"""

from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model

TOKENS, BATCH, MAX_LEN = 32, 4, 128


def teacher_forced(model, toks):
    with torch.inference_mode():
        fwd, _ = model.forward(toks)
        cache = model.init_cache(toks.shape[0], MAX_LEN)
        dec = []
        for t in range(toks.shape[1]):
            lg, cache = model.decode_step(cache, toks[:, t], t)
            dec.append(lg)
    return fwd.float(), torch.stack(dec, 1).float()


def main(archs) -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    for arch in archs:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = build_model(cfg, device=dev).init(0)
        toks = torch.randint(0, cfg.vocab_size, (BATCH, TOKENS), generator=gen, device=dev)
        fb, db = teacher_forced(model, toks)
        m32 = build_model(cfg.replace(dtype="float32", kv_cache_dtype="float32"), device=dev)
        m32.load_state_dict(model.state_dict())
        del model
        torch.cuda.empty_cache()
        f32, d32 = teacher_forced(m32, toks)
        scale = float(f32.abs().max())

        def rel(a, b):
            return float((a - b).abs().max()) / scale

        def by_position(a, b):
            return [round(float((a[:, s] - b[:, s]).abs().max()) / scale, 4)
                    for s in range(0, TOKENS, 4)]

        print(f"{arch}: float32 decode vs forward {rel(d32, f32):.3e}; bf16 decode vs forward "
              f"{rel(db, fb):.4f}; bf16 forward vs float32 {rel(fb, f32):.4f}; bf16 decode vs "
              f"float32 {rel(db, d32):.4f} (of max |logit| {scale:.4f})")
        print(f"  by position: bf16 forward vs float32 {by_position(fb, f32)}; bf16 decode vs "
              f"float32 {by_position(db, d32)}")
        print(f"  greedy agreement: bf16 forward/decode "
              f"{float((fb.argmax(-1) == db.argmax(-1)).float().mean()):.4f}, bf16/float32 "
              f"forward {float((fb.argmax(-1) == f32.argmax(-1)).float().mean()):.4f}")
        with torch.inference_mode():
            emb = m32.embed.vocab.clone()
            noise = torch.randn(emb.shape, generator=torch.Generator(device=dev).manual_seed(1),
                                device=dev)
            for eps in (2.0 ** -9, 1e-6):
                m32.embed.vocab.copy_(emb * (1 + eps * noise))
                moved, _ = m32.forward(toks)
                print(f"  an embedding perturbation of relative {eps:.3g} moves the float32 "
                      f"logits by {rel(moved.float(), f32):.4e} of the largest")
        del m32, emb, noise
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["zamba2-2.7b", "rwkv6-7b"]))
