"""Training entry point of the PyTorch port: stage-1 VLN SFT / stage-2
co-training, on one device or on a ("dp", "fsdp", "tp") mesh of ranks.

    python -m streamvln_tpu_torch.train --video_folders data/traj1,data/traj2 \
        --output_dir runs/stage1 --num_steps 1000 --batch_size 8
    torchrun --nproc_per_node 4 -m streamvln_tpu_torch.train ... --fsdp 4

A twin of `streamvln_tpu/train.py`, flag for flag, plus `--device` (default
cuda; cpu runs the plain versions of the kernels): model config overrides,
tunable-part freezing, the dataset (VLN windows plus an optional
co-training mixture), task-grouped batching, per-module learning rates,
LoRA and k-bit (--bits 8|4) training, checkpoints with resume, the
mid-training evaluation and the HF export. Weights are bf16 on the card,
f32 on the CPU, as the reference picks bf16 on its accelerator. Batches
are loaded, collated and uploaded by a worker thread
(data/prefetch.py).

Where JAX calls `jax.distributed.initialize()`, this command calls
`init_process_group` when torchrun's variables (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT) are set: NCCL on the card, gloo with --device
cpu. It then builds the mesh (parallel/mesh.py), shards the params after
they are built, and every rank runs the same sampler with the same seed
and takes its rows of each global batch. Rank 0 alone writes the logs,
checkpoints and exports (checkpoints hold full tensors, so a mesh run
resumes on one device and the other way round); the eval hook is skipped
across processes, as in JAX. A mesh larger than the world raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from streamvln_tpu_torch import configs
from streamvln_tpu_torch.data.collate import (
    CombineDataset, RobustDataset, TaskGroupedBatchSampler, collate)
from streamvln_tpu_torch.data.tokenizer import load_tokenizer
from streamvln_tpu_torch.data.vln_dataset import VLNActionDataset


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # model
    p.add_argument("--model_path", type=str, default=None,
                   help="HF checkpoint dir to load (else random init)")
    p.add_argument("--model_size", type=str, default="7b",
                   help="7b/1.5b/0.5b/tiny or any configs.LLM_REGISTRY "
                        "family name (llama2-7b, mistral-7b, "
                        "mixtral-8x7b, mpt-7b, ...)")
    p.add_argument("--spatial_pool_mode", type=str, default="bilinear")
    # streaming/data params (reference defaults)
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--num_future_steps", type=int, default=4)
    p.add_argument("--num_history", type=int, default=8)
    p.add_argument("--video_folders", type=str, required=True,
                   help="comma-separated trajectory folders")
    p.add_argument("--cotrain_yaml", type=str, default=None,
                   help="stage-2 co-training mixture yaml "
                        "(QA/SCANQA/MMC4 groups)")
    p.add_argument("--media_root_qa", type=str, default="")
    p.add_argument("--media_root_scanqa", type=str, default="")
    p.add_argument("--media_root_mmc4", type=str, default="")
    p.add_argument("--remove_init_turns", action="store_true")
    p.add_argument("--data_augmentation", action="store_true")
    p.add_argument("--model_max_length", type=int, default=32768)
    p.add_argument("--group_by_task", action="store_true", default=True)
    # optimization (the reference run's: lr 2e-5, tower lr 5e-6, warmup
    # 0.03)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--mm_vision_tower_lr", type=float, default=5e-6)
    p.add_argument("--mm_projector_lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8,
                   help="global batch size")
    p.add_argument("--grad_accum_steps", type=int, default=1)
    p.add_argument("--freeze_vision", action="store_true")
    p.add_argument("--freeze_projector", action="store_true")
    p.add_argument("--no_remat", action="store_true")
    # long-context memory knobs (the reference trains at
    # model_max_length 32768; its 7B@32k recipe is remat_chunk 7 +
    # mlp_chunk 2048 + loss_chunk 1024)
    p.add_argument("--remat_chunk", type=int, default=None,
                   help="layers per nested-remat chunk (must divide "
                   "num_layers); saves residual-stream boundaries")
    p.add_argument("--mlp_chunk", type=int, default=None,
                   help="token-chunked MLP remat (bounds [S,F] temps)")
    p.add_argument("--loss_chunk", type=int, default=512,
                   help="sequence-chunked cross-entropy block")
    # LoRA / k-bit
    p.add_argument("--lora_enable", action="store_true",
                   help="train only LoRA adapters on the LLM")
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument("--bits", type=int, default=16, choices=[4, 8, 16],
                   help="8/4: int8 (per-channel) / int4 (group-wise) "
                        "weight-only quantize of the LLM after load "
                        "(models/quant.py)")
    p.add_argument("--act_int8", action="store_true",
                   help="int8 x int8 matmuls with per-token activation "
                        "quant (requires --bits 8; straight-through "
                        "gradients)")
    # mesh over the ranks of torchrun's process group
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=None)
    p.add_argument("--tp", type=int, default=1)
    # io
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--log_steps", type=int, default=10)
    # mid-training eval: in-process held-out episode eval
    p.add_argument("--eval_steps", type=int, default=0,
                   help="evaluate every N steps (0 = off)")
    p.add_argument("--eval_episodes", type=int, default=4)
    p.add_argument("--export_hf", action="store_true",
                   help="also write an HF-format safetensors export")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="batches prepared ahead by the background "
                        "loader thread (0 = synchronous)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--report_to", choices=("none", "wandb"),
                   default="none",
                   help="mirror train metrics to wandb")
    p.add_argument("--run_name", default="streamvln_tpu")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def build_transform(enabled: bool, seed: int = 0):
    """Data augmentation (the reference stack's torchvision v2 ColorJitter /
    Posterize / Sharpness / Autocontrast), as PIL host-side equivalents."""
    if not enabled:
        return None
    from PIL import ImageEnhance, ImageOps
    rng = np.random.default_rng(seed)

    def transform(img):
        if rng.random() < 0.8:
            img = ImageEnhance.Brightness(img).enhance(
                1 + rng.uniform(-0.3, 0.3))
            img = ImageEnhance.Contrast(img).enhance(
                1 + rng.uniform(-0.3, 0.3))
            img = ImageEnhance.Color(img).enhance(
                1 + rng.uniform(-0.3, 0.3))
        if rng.random() < 0.2:
            img = ImageOps.posterize(img, int(rng.integers(4, 8)))
        if rng.random() < 0.3:
            img = ImageEnhance.Sharpness(img).enhance(
                1 + rng.uniform(-0.5, 0.5))
        if rng.random() < 0.3:
            img = ImageOps.autocontrast(img)
        return img

    return transform


def init_distributed(device: torch.device):
    """(rank, world size, whether this call made the process group): the
    group torchrun's variables describe (NCCL on cuda, gloo on cpu), one
    that is already up, or none (rank 0 of 1)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT")):
        return 0, 1, False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_rank(), dist.get_world_size(), True


def main(argv: Optional[List[str]] = None):
    args = build_argparser().parse_args(argv)
    device = configs.resolve_device(args.device)
    rank, world, own_group = init_distributed(device)
    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", torch.cuda.current_device())
    proc0 = rank == 0

    from streamvln_tpu_torch import weights
    from streamvln_tpu_torch.models import convert_hf
    from streamvln_tpu_torch.parallel import mesh as mesh_lib
    from streamvln_tpu_torch.parallel import train as train_lib
    from streamvln_tpu_torch.utils import checkpoint as ckpt

    cfg = configs.build_config(args)
    tcfg = train_lib.TrainConfig(
        learning_rate=args.learning_rate,
        vision_lr=args.mm_vision_tower_lr,
        projector_lr=args.mm_projector_lr,
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        total_steps=args.num_steps,
        freeze_vision=args.freeze_vision,
        freeze_projector=args.freeze_projector,
        grad_accum_steps=args.grad_accum_steps,
        remat=not args.no_remat,
        remat_chunk=args.remat_chunk,
        mlp_chunk=args.mlp_chunk,
        loss_chunk_size=args.loss_chunk,
        lora_only=args.lora_enable)

    tok = load_tokenizer(args.model_path, args.model_max_length)
    transform = build_transform(args.data_augmentation, args.seed)
    datasets = [RobustDataset(VLNActionDataset(
        tok, cfg, args.video_folders.split(","), transform=transform,
        remove_init_turns=args.remove_init_turns, seed=args.seed))]
    if args.cotrain_yaml:
        from streamvln_tpu_torch.data.cotrain_datasets import (
            build_cotraining_datasets)
        datasets += build_cotraining_datasets(
            tok, cfg, args.cotrain_yaml,
            media_roots={"qa": args.media_root_qa,
                         "scanqa": args.media_root_scanqa,
                         "mmc4": args.media_root_mmc4},
            seed=args.seed)
    dataset = CombineDataset(datasets)
    sampler = TaskGroupedBatchSampler(dataset.task_ids, args.batch_size,
                                      seed=args.seed)

    # --fsdp None takes the rest of the world; without a process group a
    # mesh of more than one rank is refused by make_mesh
    import torch.distributed as dist
    mesh = None
    if dist.is_initialized() or args.dp * (args.fsdp or 1) * args.tp > 1:
        mesh = mesh_lib.make_mesh(dp=args.dp, fsdp=args.fsdp, tp=args.tp)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.bits in (4, 8) and not args.lora_enable:
        # integer leaves take no gradient: only LoRA training trains with
        # a quantized base (the reference's k-bit load requires adapters)
        raise SystemExit(f"--bits {args.bits} requires --lora_enable")
    if args.act_int8 and args.bits != 8:
        raise SystemExit("--act_int8 requires --bits 8 (group-wise "
                         "int4 scales cannot ride the int32 output)")
    if args.act_int8:
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, act_int8=True))

    if args.model_path:
        params = convert_hf.load_streamvln_checkpoint(args.model_path, cfg,
                                                      dtype, device)
    else:
        params = weights.init(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device, dtype=dtype)
    if args.bits in (4, 8):
        from streamvln_tpu_torch.models import quant
        params = quant.quantize_llm(params, bits=args.bits)
    if args.lora_enable:
        from streamvln_tpu_torch.models import lora as lora_lib
        params = lora_lib.add_lora(
            params, torch.Generator(device=device).manual_seed(args.seed + 1),
            rank=args.lora_r, alpha=args.lora_alpha)
    if mesh is not None:
        params = mesh_lib.shard_params(params, mesh)
    state = train_lib.create_train_state(params, tcfg)
    del params
    state, start_step = ckpt.resume_latest(
        os.path.join(args.output_dir, "ckpt"), state)
    step_fn = train_lib.make_train_step(cfg, tcfg, device=device, mesh=mesh)

    os.makedirs(args.output_dir, exist_ok=True)
    log_path = os.path.join(args.output_dir, "train_log.jsonl")
    # wandb mirror of the JSONL log when --report_to wandb; a missing or
    # failing wandb degrades to the JSONL mirror alone
    from streamvln_tpu_torch.utils.observability import MetricsLogger
    mlog = MetricsLogger(args.output_dir, rank=rank,
                         use_wandb=(args.report_to == "wandb"),
                         run_name=args.run_name)
    evaluator = None
    if args.eval_steps > 0:
        if world > 1:
            # the params are sharded over the ranks; as in JAX, the eval
            # is skipped rather than gathered across processes
            if proc0:
                print("eval_steps: skipped on multi-host runs")
        else:
            from streamvln_tpu_torch.eval.hook import MidTrainingEvaluator
            evaluator = MidTrainingEvaluator(
                cfg, tok, n_episodes=args.eval_episodes, seed=args.seed)
    from streamvln_tpu_torch.data.prefetch import BatchPrefetcher

    def make_batch(batch_idx):
        samples = [dataset[i] for i in batch_idx]
        batch = collate(samples, cfg, max_length=args.model_max_length)
        return {k: v for k, v in batch.items()
                if k not in ("time_ids", "task_type")}

    # load, collate and upload the next batches while the device runs the
    # current step
    prefetcher = BatchPrefetcher(sampler, make_batch,
                                 depth=args.prefetch_depth, device=device)
    step = start_step
    t_last = time.perf_counter()
    try:
        while step < args.num_steps:
            batch = prefetcher.get()
            state, metrics = step_fn(state, batch)
            step += 1
            if proc0 and step % args.log_steps == 0:
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                rec = {"step": step,
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "steps_per_sec": args.log_steps / dt}
                print(json.dumps(rec), flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                mlog.log(rec, step=step)
            if evaluator is not None and step % args.eval_steps == 0:
                rec = {"step": step, **evaluator.evaluate(
                    mesh_lib.gather_tree(state.params), step)}
                print(json.dumps(rec), flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                mlog.log(rec, step=step)
            if step % args.save_steps == 0:
                ckpt.save_checkpoint(
                    os.path.join(args.output_dir, "ckpt"), state, step)
    finally:
        prefetcher.close()
        mlog.close()

    ckpt.save_checkpoint(os.path.join(args.output_dir, "ckpt"), state,
                         step, wait=True)
    if args.export_hf:
        with torch.no_grad():
            params = mesh_lib.gather_tree(state.params)
            if proc0:
                export_hf(params, cfg, args)
            del params
    if proc0:
        print(json.dumps({"final_step": step, "done": True}))
    if own_group:
        dist.destroy_process_group()
    return state


def export_hf(params: dict, cfg, args) -> None:
    """`<output_dir>/hf_export` (utils/checkpoint.save_hf, f32); under
    --lora_enable also `lora_adapters.npz`, and the export is of the
    adapters merged into the base weights, dequantized first for --bits
    8/4 (folding a delta into int8 or int4 and requantizing would round
    away deltas smaller than half the quant step)."""
    from streamvln_tpu_torch.utils.checkpoint import save_hf
    if args.lora_enable:
        from streamvln_tpu_torch.models import lora as lora_lib
        if args.bits in (4, 8):
            from streamvln_tpu_torch.models import quant
            params = quant.dequantize_llm(params)
        _, adapters = lora_lib.split_lora(params)
        flat = {k: v.detach().cpu().numpy()
                for k, v in adapters["layers"].items()}
        flat["lora_scale"] = adapters["lora_scale"].cpu().numpy()
        np.savez(os.path.join(args.output_dir, "lora_adapters.npz"), **flat)
        params = lora_lib.merge_lora(params)
    save_hf(params, cfg, os.path.join(args.output_dir, "hf_export"))


if __name__ == "__main__":
    main()
