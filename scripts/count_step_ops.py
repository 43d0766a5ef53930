#!/usr/bin/env python3
"""Count the ATen ops one decode step and one train step dispatch, on
the CPU, for this checkout or another one.

For each family's smoke config (remat on, weights from seed 0): one
``decode_step`` after three warm ones (batch 2) and one fused train
step after a warm one (seq 32 x batch 4), each under ``torch.profiler``;
prints ``{"<arch>/decode" | "<arch>/train": <aten ops>}``.  Two
checkouts that dispatch the same ops launch the same kernels on the
card, so this shows, without a card, whether a change touched the
single-device paths::

    python3 scripts/count_step_ops.py [--src CHECKOUT/src]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ARCHS = ("qwen2-0.5b", "mixtral-8x22b", "zamba2-2.7b", "rwkv6-7b", "seamless-m4t-large-v2",
         "qwen2-vl-2b")


def aten_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name.startswith("aten::") for e in prof.events())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(__file__), "..", "src"),
                    help="the src directory of the checkout to count (default: this one)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    out = {}
    for arch in ARCHS:
        cfg = smoke_config(arch).replace(remat=True)
        model = build_model(cfg, device="cpu").init(0)
        cache = model.init_cache(2, 16)
        with torch.no_grad():
            for t in range(3):
                _, cache = model.decode_step(cache, torch.tensor([1, 2]), t)
            out[f"{arch}/decode"] = aten_ops(
                lambda: model.decode_step(cache, torch.tensor([3, 4]), 3))
        params = model.trainable()
        opt_cfg = AdamWConfig(total_steps=10)
        state = init_opt_state(params, opt_cfg)
        step = make_train_step(model, opt_cfg)
        batch = synthetic_batch(cfg, ShapeConfig("train", 32, 4, "train"), 0, device="cpu")
        step(params, state, batch)
        out[f"{arch}/train"] = aten_ops(lambda: step(params, state, batch))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
