"""Co-training datasets: video-QA / 3D-QA conversation data and MMC4
interleaved image-text, plus the sampling-strategy mixture DSL.

Own copy of `streamvln_tpu/data/cotrain_datasets.py` (the reference stack's
LazySupervisedDataset mixture loader, conversation samples and MMC4
shards):
- the yaml mixture loader with first/end/random:<N|P%> sampling and
  sampling_subset keyword filters (config/co-training_data.yaml);
- video/image conversation samples {id, video|image, conversations} with
  one <image> per sampled frame: LLaVA-Video-178K QA and ScanQA/SQA3D
  (task ids 1, 2);
- MMC4 interleaved shards: text_list + image_info matched by
  matched_text_index, <= 6 images per doc, task id 3.
Video files are sampled through cv2 (the JAX package's C++ decoder is not
ported); without cv2 a video sample raises ImportError, as the reference's
cv2 branch does.
"""
from __future__ import annotations

import glob
import json
import math
import os
import random
from typing import Callable, List, Optional, Sequence

import numpy as np

from streamvln_tpu_torch.configs import StreamVLNConfig
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import Tokenizer
from streamvln_tpu_torch.ops.preprocess import preprocess_frames_host
from streamvln_tpu_torch.utils.constants import IGNORE_INDEX

MAX_MMC4_IMAGES = 6


# ---------------------------------------------------------------------------
# Mixture DSL
# ---------------------------------------------------------------------------

def apply_sampling(entries: List[dict], strategy: str = "all",
                   subset: str = "all", seed: int = 42,
                   video_key: str = "video") -> List[dict]:
    """first/end/random:<N or P%> + keyword subset filter (reference:
    streamvln_train.py:1005-1027)."""
    number = None
    if ":" in strategy:
        strategy, num = strategy.split(":")
        if "%" in num:
            number = math.ceil(int(num.rstrip("%")) * len(entries) / 100)
        else:
            number = int(num)
    if strategy == "first" and number is not None:
        entries = entries[:number]
    elif strategy == "end" and number is not None:
        entries = entries[-number:]
    elif strategy == "random" and number is not None:
        entries = list(entries)
        random.Random(seed).shuffle(entries)
        entries = entries[:number]
    if subset != "all":
        keywords = [k.strip().lower() for k in subset.split(",")]
        entries = [e for e in entries
                   if any(k in str(e.get(video_key, "")).lower()
                          for k in keywords)]
    return entries


def load_mixture_entries(yaml_path: str, group: str,
                         seed: int = 42) -> List[dict]:
    """Load one dataset group ('QA_datasets', 'SCANQA_datasets',
    'MMC4_datasets') from the mixture yaml, applying sampling."""
    import yaml
    with open(yaml_path) as f:
        spec = yaml.safe_load(f)
    out: List[dict] = []
    for ds in spec.get(group, []) or []:
        json_path = ds["json_path"]
        entries: List[dict] = []
        from streamvln_tpu_torch.data.remote import is_remote, read_bytes
        if json_path.endswith(".jsonl") and (
                is_remote(json_path) or os.path.isfile(json_path)):
            text = read_bytes(json_path).decode("utf-8")
            entries = [json.loads(l) for l in text.splitlines()
                       if l.strip()]
        elif json_path.endswith(".json"):
            # local or remote shard (reference: mmc4_dataset.py:726-735
            # reads shards through the petrel client the same way)
            entries = json.loads(read_bytes(json_path))
        elif os.path.isdir(json_path):
            for shard in sorted(glob.glob(os.path.join(json_path,
                                                       "*.jsonl"))):
                with open(shard) as f:
                    entries.extend(json.loads(l) for l in f if l.strip())
        else:
            raise ValueError(f"unsupported mixture path: {json_path}")
        entries = apply_sampling(
            entries, ds.get("sampling_strategy", "all"),
            ds.get("sampling_subset", "all"), seed)
        out.extend(entries)
    return out


# ---------------------------------------------------------------------------
# Conversation (video/image QA) dataset — tasks 1 and 2
# ---------------------------------------------------------------------------

class ConversationDataset:
    """Samples: {id, video|image, conversations: [{from, value}]}.
    `video` points at a frame directory (we sample `num_frames_qa`
    uniformly) or a single image file; one <image> sentinel per frame is
    ensured in the first human turn."""

    def __init__(self, tokenizer: Tokenizer, cfg: StreamVLNConfig,
                 entries: Sequence[dict], media_root: str,
                 task_id: int = 1, num_frames_qa: int = 8,
                 image_size: Optional[int] = None,
                 transform: Optional[Callable] = None):
        self.tok = tokenizer
        self.cfg = cfg
        self.entries = list(entries)
        self.media_root = media_root
        self.task_id = task_id
        self.num_frames_qa = num_frames_qa
        self.image_size = image_size or cfg.vision.image_size
        self.transform = transform

    def __len__(self):
        return len(self.entries)

    VIDEO_EXTS = (".mp4", ".mkv", ".avi", ".webm", ".mov", ".m4v")

    def _frame_paths(self, entry: dict) -> List[str]:
        media = entry.get("video") or entry.get("image")
        if isinstance(media, list):
            return [os.path.join(self.media_root, m) for m in media]
        path = os.path.join(self.media_root, media)
        if os.path.isdir(path):
            frames = sorted(
                f for f in os.listdir(path)
                if f.lower().endswith((".jpg", ".jpeg", ".png")))
            idx = np.linspace(0, len(frames) - 1,
                              min(self.num_frames_qa, len(frames)),
                              dtype=int)
            return [os.path.join(path, frames[i]) for i in idx]
        return [path]

    def _load_media(self, entry: dict):
        """-> (images [N, S, S, 3] f32, n_frames). Video FILES are
        container-decoded (LLaVA-Video-178K-style data; reference:
        llava/utils.py:32-81); frame dirs / image files as before."""
        media = entry.get("video") or entry.get("image")
        if isinstance(media, str) and media.lower().endswith(
                self.VIDEO_EXTS):
            frames = self._decode_video(
                os.path.join(self.media_root, media))
            return self._preprocess_frames(frames), len(frames)
        paths = self._frame_paths(entry)
        return self._load(paths), len(paths)

    def _decode_video(self, path: str) -> np.ndarray:
        """Uniform num_frames_qa sample from a video container through
        cv2."""
        import cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise ValueError(f"cannot open video {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total > 0:
            idx = set(np.linspace(0, total - 1,
                                  min(self.num_frames_qa, total),
                                  dtype=int).tolist())
            frames, i = [], 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if i in idx:
                    frames.append(frame[:, :, ::-1].copy())  # BGR->RGB
                i += 1
        else:
            # some containers (webm/streams) report frame count 0 —
            # decode everything, then subsample to num_frames_qa
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame[:, :, ::-1].copy())
            if len(frames) > self.num_frames_qa:
                keep = np.linspace(0, len(frames) - 1,
                                   self.num_frames_qa, dtype=int)
                frames = [frames[i] for i in keep]
        cap.release()
        if not frames:
            raise ValueError(f"no frames decoded from {path}")
        return np.stack(frames)

    def _preprocess_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        from PIL import Image
        raw = []
        for frame in frames_u8:
            img = Image.fromarray(frame)
            if self.transform is not None:
                img = self.transform(img)
            raw.append(np.asarray(
                img.resize((self.image_size, self.image_size),
                           Image.BICUBIC), np.uint8))
        return preprocess_frames_host(np.stack(raw), self.image_size)

    def __getitem__(self, i: int) -> dict:
        entry = self.entries[i]
        images, n_img = self._load_media(entry)

        turns = []
        for t, conv in enumerate(entry["conversations"]):
            role = "user" if conv.get("from", conv.get("role")) in (
                "human", "user") else "assistant"
            text = conv.get("value", conv.get("content", ""))
            if t == 0 and role == "user":
                have = text.count("<image>")
                if have < n_img:
                    text = "<image>" * (n_img - have) + "\n" + text
            turns.append((role, text))

        input_ids, labels = chatml.tokenize_dialogue(
            self.tok, turns, add_system=True, with_labels=True)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "images": images,
            "time_ids": np.arange(n_img, dtype=np.int32),
            "task_id": self.task_id,
        }

    def _load(self, paths: List[str]) -> np.ndarray:
        from PIL import Image

        from streamvln_tpu_torch.data.remote import open_image
        raw = []
        for p in paths:
            img = open_image(p)
            if self.transform is not None:
                img = self.transform(img)
            raw.append(np.asarray(
                img.resize((self.image_size, self.image_size),
                           Image.BICUBIC), np.uint8))
        return preprocess_frames_host(np.stack(raw), self.image_size)


# ---------------------------------------------------------------------------
# MMC4 interleaved dataset — task 3
# ---------------------------------------------------------------------------

class MMC4Dataset:
    """Docs: {text_list: [...], image_info: [{image_name,
    matched_text_index}]}; build a single-turn interleaved sample with
    <image> preceding each matched sentence (reference:
    mmc4_dataset.py:779-799)."""

    def __init__(self, tokenizer: Tokenizer, cfg: StreamVLNConfig,
                 entries: Sequence[dict], image_root: str,
                 task_id: int = 3, image_size: Optional[int] = None):
        self.tok = tokenizer
        self.cfg = cfg
        self.image_root = image_root
        self.task_id = task_id
        self.image_size = image_size or cfg.vision.image_size
        self.entries = [e for e in entries
                        if e.get("image_info") and e.get("text_list")]

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> dict:
        entry = self.entries[i]
        infos = sorted(entry["image_info"],
                       key=lambda x: x.get("matched_text_index", 0))
        infos = infos[:MAX_MMC4_IMAGES]
        texts = list(entry["text_list"])
        by_index = {}
        for info in infos:
            by_index.setdefault(
                int(info.get("matched_text_index", 0)), []).append(info)

        pieces = []
        paths = []
        for t, sent in enumerate(texts):
            for info in by_index.get(t, []):
                pieces.append("<image>")
                paths.append(os.path.join(self.image_root,
                                          info["image_name"]))
            pieces.append(sent)
        text = "\n".join(pieces)

        # interleaved pretraining supervises the full document: a single
        # assistant turn carrying the interleaved text
        input_ids, labels = chatml.tokenize_dialogue(
            self.tok, [("assistant", text)], add_system=False,
            with_labels=True)

        from PIL import Image

        from streamvln_tpu_torch.data.remote import open_image
        raw = [np.asarray(open_image(p).resize(
            (self.image_size, self.image_size), Image.BICUBIC), np.uint8)
            for p in paths]
        images = preprocess_frames_host(np.stack(raw), self.image_size)
        return {
            "input_ids": input_ids,
            "labels": labels,
            "images": images,
            "time_ids": np.arange(len(paths), dtype=np.int32),
            "task_id": self.task_id,
        }


def build_cotraining_datasets(tokenizer, cfg, yaml_path: str,
                              media_roots: Optional[dict] = None,
                              seed: int = 42) -> List:
    """Mixture yaml -> [ConversationDataset(QA, task 1),
    ConversationDataset(3D-QA, task 2), MMC4Dataset(task 3)], skipping
    empty groups (reference task ids: streamvln_train.py:1440-1458)."""
    media_roots = media_roots or {}
    out = []
    qa = load_mixture_entries(yaml_path, "QA_datasets", seed)
    if qa:
        out.append(ConversationDataset(
            tokenizer, cfg, qa, media_roots.get("qa", ""), task_id=1))
    scan = load_mixture_entries(yaml_path, "SCANQA_datasets", seed)
    if scan:
        out.append(ConversationDataset(
            tokenizer, cfg, scan, media_roots.get("scanqa", ""),
            task_id=2))
    mmc4 = load_mixture_entries(yaml_path, "MMC4_datasets", seed)
    if mmc4:
        out.append(MMC4Dataset(
            tokenizer, cfg, mmc4, media_roots.get("mmc4", ""),
            task_id=3))
    return out
