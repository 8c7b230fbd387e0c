"""Evaluation entry point of the PyTorch port (streamvln_eval parity CLI).

    python -m streamvln_tpu_torch.eval_cli --model_path <weights_dir> \
        --env_backend habitat --habitat_config_path config/vln_r2r.yaml \
        --eval_split val_unseen --output_path <out>

A twin of `streamvln_tpu/eval_cli.py`, with its argument surface
(--model_path --eval_split --output_path --num_future_steps --num_frames
--num_history --model_max_length --n_envs --bits --spec_lookup
--rank/--world_size ...) plus `--device` (default cuda; cpu runs the
plain versions of the kernels). --model_path is an HF-format checkpoint
directory, as the published weights ship: its safetensors shards (or
pytorch_model*.bin) are converted at load (models/convert_hf.py) and its
tokenizer files give the HF tokenizer (which needs `transformers`); a
directory without shards gets random weights from seed 0, one without
tokenizer files the ByteTokenizer. Weights are bf16 on the card, f32 on
the CPU (the reference picks bf16 on its accelerator), optionally merged
with LoRA adapters, the LLM quantized (--bits 4|8) and the tower's
projections quantized to int8 (--vision_int8: int8 x int8 products with
per-token activation quantization), all on the device, and served by the
engine with prompt-lookup speculation (--spec_lookup, 6 by default) over a
bf16 or, with --kv_int8, an int8 KV cache. The env is the fake one or
habitat-sim (--env_backend habitat, eval/habitat_backend.py). One env runs
VLNEvaluator; --n_envs > 1 runs BatchedVLNEvaluator, with each env in a
worker process by default.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
from typing import Optional

import torch


def build_agent(model_path: Optional[str], model_size: str = "7b",
                num_frames: int = 32, num_future_steps: int = 4,
                num_history: int = 8, model_max_length: int = 4096,
                cache_capacity: int = 4096, max_new_tokens: int = 16,
                n_envs: int = 1, lora_adapters: Optional[str] = None,
                spec_lookup: int = 6, bits: int = 16,
                kv_int8: bool = False, vision_int8: bool = False,
                device="cuda"):
    """A VLNAgent over a StreamingEngine on `device`, with the reference's
    choices: the checkpoint in `model_path` (random weights from seed 0
    when it holds no shards), its tokenizer (the ByteTokenizer when it
    holds no tokenizer files), {im_end, eos} as stop ids, and a random
    conjunction in every observation prompt. kv_int8 gives the engine an
    int8 KV cache; vision_int8 quantizes the tower's projections to int8
    on the device after the build."""
    from streamvln_tpu_torch import weights
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.configs import build_config, resolve_device
    from streamvln_tpu_torch.data.tokenizer import load_tokenizer
    from streamvln_tpu_torch.models import convert_hf
    from streamvln_tpu_torch.models.fuse import fuse_projections
    from streamvln_tpu_torch.streaming.engine import StreamingEngine

    device = resolve_device(device)
    args = argparse.Namespace(
        model_size=model_size, spatial_pool_mode="bilinear",
        num_frames=num_frames, num_future_steps=num_future_steps,
        num_history=num_history)
    cfg = build_config(args)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    tok = load_tokenizer(model_path, model_max_length)
    has_ckpt = bool(model_path and os.path.isdir(model_path) and any(
        f.endswith((".safetensors", ".bin"))
        for f in os.listdir(model_path)))
    if has_ckpt:
        # each stack is built in place on the device, so the card never
        # holds a second copy of it
        params = convert_hf.load_streamvln_checkpoint(model_path, cfg, dtype,
                                                      device)
    else:
        params = weights.init(cfg,
                              torch.Generator(device=device).manual_seed(0),
                              device=device, dtype=dtype)
    if lora_adapters:
        # the reference's 'lora' model builder: attach exported adapters
        # and fold them into the base weights
        from streamvln_tpu_torch.models import lora
        params = lora.merge_lora(lora.apply_adapters_npz(params,
                                                         lora_adapters))
    if bits in (4, 8):
        from streamvln_tpu_torch.models import quant
        params = quant.quantize_llm(params, bits=bits)
    if vision_int8:
        from streamvln_tpu_torch.models import quant
        params = dict(params, vision=quant.quantize_vision(params["vision"]))
    # fuse here, so the engine's fuse is a no-op and the unfused stacks are
    # freed before the engine allocates its caches
    params = fuse_projections(params)
    stop = tuple(dict.fromkeys((tok.im_end_id, tok.eos_id)))
    engine = StreamingEngine(
        params, cfg, n_envs=n_envs, cache_capacity=cache_capacity,
        max_new_tokens=max_new_tokens, stop_ids=stop, compute_dtype=dtype,
        spec_lookup=spec_lookup, kv_int8=kv_int8, device=device)
    return VLNAgent(engine, tok, deterministic_conjunction=False)


def make_env(backend: str, split: str, num_episodes: int, seed: int,
             habitat_config_path: Optional[str]):
    """The evaluation env: habitat-sim configured for the benchmark
    (SystemExit where habitat is absent), or FakeNavEnv over
    `num_episodes` seeded episodes (480x640 frames)."""
    if backend == "habitat":
        try:
            from streamvln_tpu_torch.eval.habitat_backend import (
                make_habitat_env)
            return make_habitat_env(habitat_config_path, split)
        except ImportError as e:
            raise SystemExit(
                f"habitat backend requested but unavailable: {e}; "
                f"use --env_backend fake for simulator-free runs")
    from streamvln_tpu_torch.eval.fake_env import FakeNavEnv, make_episodes
    return FakeNavEnv(make_episodes(num_episodes, seed=seed))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--model_size", type=str, default="7b")
    p.add_argument("--lora_adapters", type=str, default=None,
                   help="lora_adapters.npz (the trainer's export); merged "
                        "into the base weights")
    p.add_argument("--habitat_config_path", type=str,
                   default="config/vln_r2r.yaml")
    p.add_argument("--eval_split", type=str, default="val_unseen")
    p.add_argument("--output_path", type=str,
                   default="./results/val_unseen/streamvln")
    p.add_argument("--num_future_steps", type=int, default=4)
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--num_history", type=int, default=8)
    p.add_argument("--model_max_length", type=int, default=4096)
    p.add_argument("--env_backend", choices=["habitat", "fake"],
                   default="fake")
    p.add_argument("--num_episodes", type=int, default=8,
                   help="fake backend episode count")
    p.add_argument("--max_steps_per_episode", type=int, default=None)
    p.add_argument("--save_video", action="store_true", default=False)
    p.add_argument("--n_envs", type=int, default=1,
                   help=">1: batched multi-env eval (one model, N "
                        "parallel simulators per process)")
    p.add_argument("--env_workers", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="host each env slot in its own worker process "
                        "(default for --n_envs > 1; --no-env_workers "
                        "steps them in-process)")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("RANK", 0)))
    p.add_argument("--world_size", type=int,
                   default=int(os.environ.get("WORLD_SIZE", 1)))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bits", type=int, default=16, choices=[4, 8, 16],
                   help="inference weight quantization; 4 runs the int4 "
                        "dequant-matmul kernels")
    p.add_argument("--kv_int8", action="store_true", default=False,
                   help="int8 KV cache (int8 values, f32 scales per token "
                        "and head)")
    p.add_argument("--vision_int8", action="store_true", default=False,
                   help="int8 x int8 tower matmuls (per-token activation "
                        "quantization)")
    p.add_argument("--spec_lookup", type=int, default=6,
                   help="prompt-lookup speculative decode: verify this "
                        "many drafted tokens per decode forward "
                        "(greedy-exact; 0 disables)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    agent = build_agent(
        args.model_path, args.model_size, args.num_frames,
        args.num_future_steps, args.num_history, args.model_max_length,
        n_envs=args.n_envs, lora_adapters=args.lora_adapters,
        spec_lookup=args.spec_lookup, bits=args.bits,
        kv_int8=args.kv_int8, vision_int8=args.vision_int8,
        device=args.device)

    if args.n_envs > 1:
        from streamvln_tpu_torch.eval.batched_evaluator import (
            BatchedVLNEvaluator)
        env = make_env(args.env_backend, args.eval_split,
                       args.num_episodes, args.seed,
                       args.habitat_config_path)
        episodes = list(env.episodes)[args.rank::args.world_size]
        env.close()
        factory = functools.partial(
            make_env, args.env_backend, args.eval_split,
            args.num_episodes, args.seed, args.habitat_config_path)
        if args.env_workers:
            # each simulator in its own process; frames are resized there
            # (PIL), so the pipes carry compact uploads
            from streamvln_tpu_torch.eval.env_workers import (
                remote_env_factory, resize_rgb_transform)
            factory = remote_env_factory(
                factory, obs_transform=resize_rgb_transform(
                    agent.cfg.vision.image_size))
        ev = BatchedVLNEvaluator(
            factory, agent, args.output_path,
            max_steps_per_episode=args.max_steps_per_episode)
        try:
            results = ev.run(episodes)
        finally:
            ev.close()
        n = max(len(results), 1)
        final = {
            "sucs_all": sum(r["success"] for r in results) / n,
            "spls_all": sum(r["spl"] for r in results) / n,
            "oss_all": sum(r["os"] for r in results) / n,
            "ones_all": sum(r["ne"] for r in results) / n,
            "length": len(results),
        }
        if results and all("ndtw" in r for r in results):
            final["ndtw_all"] = sum(r["ndtw"] for r in results) / n
        print(json.dumps(final))
        return final

    from streamvln_tpu_torch.eval.evaluator import VLNEvaluator
    env = make_env(args.env_backend, args.eval_split, args.num_episodes,
                   args.seed, args.habitat_config_path)
    ev = VLNEvaluator(env, agent, args.output_path, rank=args.rank,
                      world_size=args.world_size,
                      save_video=args.save_video,
                      max_steps_per_episode=args.max_steps_per_episode)
    final = ev.aggregate([ev.eval_action()])
    print(json.dumps(final))
    return final


if __name__ == "__main__":
    main()
