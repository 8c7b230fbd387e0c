"""VLN action-trajectory dataset: 32-step windows of expert episodes.

Own copy of `streamvln_tpu/data/vln_dataset.py` (data format parity with
the reference's streamvln/dataset/vln_action_dataset.py and the oracle
generator streamvln_trajectory_generation.py:118-137):
- trajectory folder: `<video>/rgb/NNN.jpg` frames + an `annotations.json`
  listing `{id, video, instructions[], actions[]}` per episode;
- sample = one `num_frames`-step window: actions shifted by one with STOP
  appended, one conversation round per `num_future_steps` actions (human
  turn '<conjunction> <image>.', gpt turn the round's action glyphs);
  windows after the first get the history clause + <memory> and history
  frames sampled at arange(valid, t0 + valid, max(t0 // num_history, 1));
- the first round's human turn carries the task prompt with the episode's
  instruction.

The window logic is split from the file reading: `vln_window` picks the
window's steps and frame indices, `vln_sample` builds the conversation
over frames that are already preprocessed (numpy or tensors, e.g. made
on the card), and `VLNActionDataset.__getitem__` loads the JPEGs between
the two: through the native C++ loader (`native/`) where it builds and no
augmentation is asked for, else with PIL (`preprocess_frames_host`), as
the reference chooses. PIL is imported only where files are read or
written.
"""
from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from streamvln_tpu_torch.configs import StreamVLNConfig
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import Tokenizer
from streamvln_tpu_torch.ops.preprocess import preprocess_frames_host
from streamvln_tpu_torch.utils.constants import (DEFAULT_MEMORY_TOKEN,
                                                 NAV_PROMPT)


def vln_window(cfg: StreamVLNConfig, actions: Sequence[int], start_idx: int,
               valid_idx: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """(time_ids, the window's target actions, episode frame indices of the
    sample: history frames first, then one current frame per round)."""
    nf, nfs, nh = cfg.num_frames, cfg.num_future_steps, cfg.num_history
    shifted = list(actions[1 + valid_idx:]) + [0]
    time_ids = np.arange(start_idx, min(start_idx + nf, len(shifted)))
    assert len(time_ids) > 0
    win_actions = np.asarray(shifted)[time_ids]
    s, e = time_ids[0] + valid_idx, time_ids[-1] + 1 + valid_idx
    sample_ids = np.arange(s, e, nfs, dtype=np.int64)
    if time_ids[0] != 0:
        hist_ids = np.arange(valid_idx, time_ids[0] + valid_idx,
                             max(time_ids[0] // nh, 1))
    else:
        hist_ids = np.zeros((0,), np.int64)
    return time_ids, win_actions, np.concatenate([hist_ids, sample_ids])


def vln_sample(tok: Tokenizer, cfg: StreamVLNConfig, images,
               instruction: str, win_actions: np.ndarray, start_idx: int,
               time_ids: np.ndarray, rng: Optional[np.random.Generator],
               task_id: int = 0) -> dict:
    """One training sample from a window's preprocessed frames [V, S, S, 3]
    (from `vln_window`'s frame indices): the ChatML conversation with
    labels, images as given, time_ids and task_id."""
    nfs = cfg.num_future_steps
    base = NAV_PROMPT.replace("<instruction>.", instruction)
    if start_idx != 0:
        base += (" These are your historical observations: "
                 f"{DEFAULT_MEMORY_TOKEN}.")
    turns = []
    j = 0
    first = True
    while j < len(win_actions):
        step_actions = win_actions[j: j + nfs]
        turns.append(("user", chatml.observation_prompt(
            rng, base if first else "")))
        turns.append(("assistant", chatml.actions_to_text(step_actions)))
        first = False
        j += len(step_actions)
    input_ids, labels = chatml.tokenize_dialogue(tok, turns, add_system=True,
                                                 with_labels=True)
    return {"input_ids": input_ids, "labels": labels, "images": images,
            "time_ids": np.asarray(time_ids, np.int32), "task_id": task_id}


class VLNActionDataset:
    task_id = 0

    def __init__(self, tokenizer: Tokenizer, cfg: StreamVLNConfig,
                 video_folders: Sequence[str],
                 transform: Optional[Callable] = None,
                 remove_init_turns: bool = False,
                 image_size: Optional[int] = None,
                 seed: int = 0):
        self.tok = tokenizer
        self.cfg = cfg
        self.transform = transform
        self.image_size = image_size or cfg.vision.image_size
        self.rng = np.random.default_rng(seed)

        self.nav_data = []
        for vf in video_folders:
            with open(os.path.join(vf, "annotations.json")) as f:
                anno = json.load(f)
            for item in anno:
                item = dict(item)
                item["video"] = os.path.join(vf, item["video"])
                self.nav_data.append(item)

        nf = cfg.num_frames
        self.data_list = []
        for ep_id, item in enumerate(self.nav_data):
            actions = item["actions"]
            if len(actions) < 4:
                continue
            instructions = item["instructions"]
            if not isinstance(instructions, list):
                instructions = [instructions]
            for ins_id in range(len(instructions)):
                valid_idx = 0
                if remove_init_turns:
                    valid_idx = self._count_init_turns(actions)
                if len(actions) - valid_idx < 4:
                    continue
                num_rounds = (len(actions) - valid_idx) // nf
                for n in range(num_rounds + 1):
                    if n * nf == len(actions) - valid_idx:
                        continue
                    self.data_list.append((ep_id, ins_id, n * nf,
                                           valid_idx))

    @staticmethod
    def _count_init_turns(actions: Sequence[int]) -> int:
        """Skip the leading pure-rotation prefix (remove_init_turns)."""
        i = 0
        while i < len(actions) and actions[i] in (2, 3):
            i += 1
        return i if i < len(actions) else 0

    def __len__(self):
        return len(self.data_list)

    @property
    def task(self):
        return self.task_id

    def __getitem__(self, i: int) -> dict:
        ep_id, ins_id, start_idx, valid_idx = self.data_list[i]
        data = self.nav_data[ep_id]
        video_path = data["video"]
        frames = sorted(os.listdir(os.path.join(video_path, "rgb")))
        instructions = data["instructions"]
        if not isinstance(instructions, list):
            instructions = [instructions]
        time_ids, win_actions, frame_ids = vln_window(
            self.cfg, data["actions"], start_idx, valid_idx)
        images = self._load_images([os.path.join(video_path, "rgb",
                                                 frames[j])
                                    for j in frame_ids])
        return vln_sample(self.tok, self.cfg, images, instructions[ins_id],
                          win_actions, start_idx, time_ids, self.rng,
                          self.task_id)

    def _load_images(self, paths: List[str]) -> np.ndarray:
        # the threaded C++ decode, resize and normalize (native/) where it
        # builds and no augmentation is asked for, else PIL, as the
        # reference chooses
        if self.transform is None:
            from streamvln_tpu_torch import native
            if native.available():
                return native.load_preprocess_jpegs(paths, self.image_size)
        from PIL import Image
        raw = []
        for p in paths:
            img = Image.open(p).convert("RGB")
            if self.transform is not None:
                img = self.transform(img)
            raw.append(np.asarray(img, np.uint8))
        return preprocess_frames_host(np.stack(raw), self.image_size)


def write_trajectory(root: str, episode_id: str, frames: np.ndarray,
                     instructions: Sequence[str],
                     actions: Sequence[int]) -> dict:
    """Write one episode in the trajectory format (the oracle generator's
    output; reference: streamvln_trajectory_generation.py:85-123).
    Returns the annotation entry (video path relative to root)."""
    from PIL import Image
    video_rel = os.path.join("images", episode_id)
    rgb_dir = os.path.join(root, video_rel, "rgb")
    os.makedirs(rgb_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(rgb_dir, f"{i:03d}.jpg"))
    return {
        "id": episode_id,
        "video": video_rel,
        "instructions": list(instructions),
        "actions": list(map(int, actions)),
    }


def write_annotations(root: str, entries: List[dict]):
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump(entries, f)
