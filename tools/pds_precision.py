"""Does the bf16 rounding of P and dS in K4/K5 cost Gemma's training
gradients their precision? (ROADMAP §3, item 3.10.)

    python3 tools/pds_precision.py

Runs chip_smoke.py's phase-12a comparison on the card: `train.main
--model_size gemma-2b --lora_enable` for GEMMA_STEPS micro-steps (its
checkpoint writes skipped), then the LoRA gradients of one fresh
micro-batch through attn_impl "chunked" and "dense" (plain PyTorch
attention) and through the kernels ("auto") as built from `csrc/` and as
tools/ablate.py's copies build them with P and dS kept as hi + lo bf16
pairs: `bwd_pds_hilo` (K4/K5) and `pds_hilo_all` (K3's P as well). Prints
1 - cos(x, chunked) for each beside 1 - cos(dense, chunked), and K4/K5's
device time at Gemma's training shape (B=2, S=4096, 3,900 valid, 8/1
heads, D=256) in each build, then one JSON line. Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ablate  # noqa: E402
import chip_smoke as cs  # noqa: E402
from streamvln_tpu_torch.kernels import build  # noqa: E402

HILO = ("bwd_pds_hilo", "pds_hilo_all")


def gemma_state(torch, np, tmp):
    """12a's command: the trained params and the config."""
    from streamvln_tpu_torch import train
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch.utils import checkpoint
    traj, out = os.path.join(tmp, "traj"), os.path.join(tmp, "run")
    os.makedirs(traj)
    cs.write_trajectories(np, traj, 3, seed=12)
    argv = ["--video_folders", traj, "--output_dir", out,
            "--model_size", "gemma-2b", "--lora_enable", "--batch_size", "2",
            "--num_steps", str(cs.GEMMA_STEPS), "--save_steps", "1000",
            "--log_steps", "1", "--prefetch_depth", "2"]
    real_save = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda d, st, step, **kw: True
    try:
        state = train.main(argv)
    finally:
        checkpoint.save_checkpoint = real_save
    cfg = build_config(argparse.Namespace(
        model_size="gemma-2b", spatial_pool_mode="bilinear", num_frames=32,
        num_future_steps=4, num_history=8))
    return state.params, cfg


def kernel_ms(torch, fa):
    """K4 and K5 device ms at Gemma's training shape."""
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    B, S, Hq, Hkv, D = 2, 4096, 8, 1, 256
    q, do = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    qp, kp = cs.train_positions(torch, B, S, 3900, "cuda")
    o, lse = fa.flash_attention_lse(q, k, v, qp, kp)
    args = (q, k, v, do, lse, fa._dsum(do, o), qp, kp)
    return {"K4": cs.device_ms(torch, [lambda: fa.flash_bwd_dq(*args)], 10),
            "K5": cs.device_ms(torch, [lambda: fa.flash_bwd_dkv(*args)],
                               10)}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pds_precision: needs a CUDA card", file=sys.stderr)
        return 2
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models import streamvln
    from streamvln_tpu_torch.ops import flash_attention as fa
    builds = {n: ablate.build_variant(n) for n in HILO}
    build.build_all()
    card = cs.card_line()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="pds_precision_")
    try:
        params, cfg = gemma_state(torch, np, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    batch = cs.vln_batches(torch, np, cfg, ByteTokenizer(), 1, 2,
                           seed=12)[0]

    def grads(impl):
        return cs.lora_loss_and_grads(torch, streamvln, params, cfg, batch,
                                      impl)
    ref = {impl: grads(impl) for impl in ("chunked", "dense", "auto")}
    ms = {"auto": kernel_ms(torch, fa)}
    for n in HILO:
        ablate.use_variant(builds[n])
        ref[n] = grads("auto")
        ms[n] = kernel_ms(torch, fa)
    gc_ = ref["chunked"][1]
    rec = {"card": card, "bucket": int(batch["valid"].shape[1]),
           "loss": {k: v[0] for k, v in ref.items()},
           "one_minus_cos_vs_chunked": {
               k: 1 - torch.nn.functional.cosine_similarity(
                   v[1], gc_, dim=0).item()
               for k, v in ref.items() if k != "chunked"},
           "kernel_ms_d256": ms}
    for k, v in rec["one_minus_cos_vs_chunked"].items():
        print(f"1 - cos({k}, chunked) = {v:.6g}", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
