"""The port's training data and state modules against the JAX package's
on the same inputs, on the CPU: the batch prefetcher
(tests/test_prefetch.py's cases), the co-training datasets
(tests/test_cotrain.py's: sampling strategies, video-directory, single-
and multi-image conversations, MMC4 interleave, the mixture yaml), the
remote opener (the remote half of tests/test_remote_and_moderation.py),
every conversation template's prompt, and the training state's
checkpoints (int8, packed int4, bf16 and the accumulator bit-exact,
max_to_keep, a cut save ignored, a step saved twice as orbax saves it,
resume_latest on an empty directory). Samples are compared exactly (ids,
labels, time ids) and images to 1e-6 (the same PIL arithmetic)."""
import io
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.configs import tiny_streamvln as j_tiny
from streamvln_tpu.data import conversation as jconv
from streamvln_tpu.data import cotrain_datasets as jco
from streamvln_tpu.data import prefetch as jpf
from streamvln_tpu.data import remote as jremote
from streamvln_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from streamvln_tpu.utils import checkpoint as jck
from streamvln_tpu_torch.configs import tiny_streamvln as t_tiny
from streamvln_tpu_torch.data import conversation as tconv
from streamvln_tpu_torch.data import cotrain_datasets as tco
from streamvln_tpu_torch.data import prefetch as tpf
from streamvln_tpu_torch.data import remote as tremote
from streamvln_tpu_torch.data.collate import CombineDataset, collate
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import quant as tquant
from streamvln_tpu_torch.parallel.train import (TrainConfig, TrainState,
                                                create_train_state,
                                                tree_leaves)
from streamvln_tpu_torch.utils import checkpoint as tck
from streamvln_tpu_torch.utils.constants import (IGNORE_INDEX,
                                                 IMAGE_TOKEN_INDEX)


class Sampler:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


PACKAGES = {"jax": jpf.BatchPrefetcher, "port": tpf.BatchPrefetcher}


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def test_prefetch_order_cycles_and_sync_match_jax():
    """Order, cycling and depth=0 against the JAX prefetcher: the same
    sequence of batches from both, at depth 2, 3 and 0."""
    sampler = Sampler([[0, 1], [2, 3], [4, 5]])
    for depth in (2, 3, 0):
        got = {}
        for name, cls in PACKAGES.items():
            with cls(sampler, lambda idx: {"idx": list(idx)},
                     depth=depth) as pf:
                got[name] = [pf.get()["idx"] for _ in range(7)]
        assert got["port"] == got["jax"] == [[0, 1], [2, 3], [4, 5],
                                             [0, 1], [2, 3], [4, 5], [0, 1]]


def test_prefetch_runs_ahead():
    """With depth 2 the worker prepares batches while the consumer
    waits: the loaded count outruns the consumed count, in both."""
    for cls in PACKAGES.values():
        loaded = []
        lock = threading.Lock()

        def make(idx):
            with lock:
                loaded.append(idx[0])
            return {"v": idx[0]}

        with cls(Sampler([[i] for i in range(10)]), make, depth=2) as pf:
            pf.get()
            deadline = time.time() + 5
            while len(loaded) < 3 and time.time() < deadline:
                time.sleep(0.01)
            assert len(loaded) >= 3


@pytest.mark.parametrize("depth", [2, 0])
def test_prefetch_propagates_worker_error(depth):
    def make(idx):
        if idx[0] == 2:
            raise ValueError("boom on 2")
        return {"v": idx[0]}

    for cls in PACKAGES.values():
        with cls(Sampler([[0], [1], [2], [3]]), make, depth=depth) as pf:
            assert pf.get()["v"] == 0
            assert pf.get()["v"] == 1
            with pytest.raises(ValueError, match="boom on 2"):
                pf.get()


def test_prefetch_close_joins_thread_and_empty_sampler_raises():
    for cls in PACKAGES.values():
        ev = threading.Event()

        def make(idx):
            ev.set()
            return {"v": idx[0]}

        pf = cls(Sampler([[0]]), make, depth=1)
        assert ev.wait(5)
        pf.close()
        assert not pf._thread.is_alive()
        with cls(Sampler([]), lambda i: {}, depth=1) as pf:
            with pytest.raises(RuntimeError, match="empty"):
                pf.get()


@pytest.mark.parametrize("depth", [2, 0])
def test_prefetch_uploads_to_the_device(depth):
    """With a device, every array of a batch arrives as a tensor on it
    (the CPU here; a CUDA device copies on a side stream), equal to the
    batch made; other values pass through."""
    def make(idx):
        return {"x": np.full((2, 3), idx[0], np.float32),
                "ids": np.arange(4, dtype=np.int32) + idx[0],
                "name": f"b{idx[0]}"}

    with tpf.BatchPrefetcher(Sampler([[1], [2]]), make, depth=depth,
                             device="cpu") as pf:
        for i in (1, 2, 1):
            b = pf.get()
            assert isinstance(b["x"], torch.Tensor) and b["x"].device.type \
                == "cpu"
            torch.testing.assert_close(b["x"], torch.full((2, 3), float(i)))
            assert b["ids"].dtype == torch.int32 and b["ids"][0] == i
            assert b["name"] == f"b{i}"


# ---------------------------------------------------------------------------
# co-training datasets
# ---------------------------------------------------------------------------

def test_sampling_strategies_match_jax():
    entries = [{"video": f"nextqa/v{i}"} for i in range(10)] \
        + [{"video": f"ego4d/v{i}"} for i in range(10)]
    for strategy, subset in (("first:5", "all"), ("end:3", "all"),
                             ("random:7", "all"), ("first:50%", "all"),
                             ("random:30%", "ego4d"), ("all", "nextqa"),
                             ("all", "NEXTQA, ego4d"), ("end:4", "ego4d")):
        got = tco.apply_sampling(entries, strategy, subset, seed=5)
        want = jco.apply_sampling(entries, strategy, subset, seed=5)
        assert got == want, (strategy, subset)
    assert len(tco.apply_sampling(entries, "first:50%")) == 10
    only = tco.apply_sampling(entries, "all", subset="nextqa")
    assert len(only) == 10 and all("nextqa" in e["video"] for e in only)


@pytest.fixture(scope="module")
def media_tree(tmp_path_factory):
    """tests/test_cotrain.py's tree: a 12-frame video directory and two
    single images."""
    from PIL import Image
    root = str(tmp_path_factory.mktemp("media"))
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "vid0"))
    for i in range(12):
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            os.path.join(root, "vid0", f"{i:03d}.jpg"))
    for name in ("img0.jpg", "img1.jpg"):
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            os.path.join(root, name))
    return root


def _same_sample(t, j):
    for k in ("input_ids", "labels", "time_ids"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_allclose(t["images"], j["images"], atol=1e-6)
    assert t["task_id"] == j["task_id"]


CONVERSATIONS = {
    "video": {"id": 0, "video": "vid0", "conversations": [
        {"from": "human", "value": "What happens in the video?"},
        {"from": "gpt", "value": "A thing happens."}]},
    "single_image": {"id": 1, "image": "img0.jpg", "conversations": [
        {"from": "human", "value": "<image>\nDescribe."},
        {"from": "gpt", "value": "A noisy image."}]},
    "multi_image": {"id": 2, "image": ["img0.jpg", "img1.jpg"],
                    "conversations": [
                        {"role": "user", "content": "Compare them."},
                        {"role": "assistant", "content": "Alike."},
                        {"from": "human", "value": "Sure?"},
                        {"from": "gpt", "value": "Yes."}]},
}


@pytest.mark.parametrize("kind,n_images,task", [
    ("video", 4, 1), ("single_image", 1, 2), ("multi_image", 2, 1)])
def test_conversation_dataset_matches_jax(media_tree, kind, n_images, task):
    cfg, jc = t_tiny(), j_tiny()
    entry = [CONVERSATIONS[kind]]
    t = tco.ConversationDataset(ByteTokenizer(), cfg, entry, media_tree,
                                task_id=task, num_frames_qa=4)[0]
    j = jco.ConversationDataset(JByteTokenizer(), jc, entry, media_tree,
                                task_id=task, num_frames_qa=4)[0]
    _same_sample(t, j)
    assert (t["input_ids"] == IMAGE_TOKEN_INDEX).sum() == n_images
    assert len(t["images"]) == n_images and t["task_id"] == task
    assert (t["labels"] != IGNORE_INDEX).sum() > 0
    batch = collate([t], cfg, length_buckets=(512, 1024))
    assert batch["images"].shape[0] == 1


def test_video_file_needs_cv2(media_tree, monkeypatch):
    """A video file is sampled through cv2 where the native decoder is
    not built; without cv2 the sample raises ImportError, as the
    reference's cv2 branch does (both packages' C++ decoders switched off
    here)."""
    from streamvln_tpu import native as jnative
    from streamvln_tpu_torch import native as tnative
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(jnative, "video_available", lambda: False)
    monkeypatch.setattr(tnative, "video_available", lambda: False)
    entry = [{"id": 3, "video": "clip.mp4", "conversations": [
        {"from": "human", "value": "?"}, {"from": "gpt", "value": "!"}]}]
    for mod, tok, cfg in ((tco, ByteTokenizer(), t_tiny()),
                          (jco, JByteTokenizer(), j_tiny())):
        with pytest.raises(ImportError):
            mod.ConversationDataset(tok, cfg, entry, media_tree)[0]


def test_mmc4_interleave_matches_jax(media_tree):
    entries = [{
        "text_list": ["First sentence.", "Second sentence.",
                      "Third sentence."],
        "image_info": [
            {"image_name": "img0.jpg", "matched_text_index": 0},
            {"image_name": "img1.jpg", "matched_text_index": 2},
        ],
    }, {"text_list": ["no images"], "image_info": []}]
    t_ds = tco.MMC4Dataset(ByteTokenizer(), t_tiny(), entries, media_tree)
    j_ds = jco.MMC4Dataset(JByteTokenizer(), j_tiny(), entries, media_tree)
    assert len(t_ds) == len(j_ds) == 1
    t = t_ds[0]
    _same_sample(t, j_ds[0])
    assert (t["input_ids"] == IMAGE_TOKEN_INDEX).sum() == 2
    assert t["task_id"] == 3
    decoded = ByteTokenizer().decode(t["input_ids"].tolist())
    assert decoded.index("<image>") < decoded.index("First")


def test_mixture_yaml_matches_jax(media_tree, tmp_path):
    """QA from a .json (first:4), 3D-QA from a .jsonl (random:50%), MMC4
    from a directory of .jsonl shards: the same entries and samples."""
    qa_json = str(tmp_path / "qa.json")
    with open(qa_json, "w") as f:
        json.dump([{"id": i, "video": "vid0", "conversations": [
            {"from": "human", "value": f"Q{i}?"},
            {"from": "gpt", "value": "A."}]} for i in range(6)], f)
    scan = str(tmp_path / "scan.jsonl")
    with open(scan, "w") as f:
        for i in range(4):
            f.write(json.dumps({"id": i, "image": "img1.jpg",
                                "conversations": [
                                    {"from": "human", "value": f"S{i}"},
                                    {"from": "gpt", "value": "ok"}]}) + "\n")
    mmc4_dir = tmp_path / "mmc4"
    mmc4_dir.mkdir()
    with open(mmc4_dir / "shard0.jsonl", "w") as f:
        f.write(json.dumps({
            "text_list": ["Hello."],
            "image_info": [{"image_name": "img0.jpg",
                            "matched_text_index": 0}]}) + "\n")
    yaml_path = str(tmp_path / "mix.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"""QA_datasets:
  - json_path: {qa_json}
    sampling_strategy: first:4
SCANQA_datasets:
  - json_path: {scan}
    sampling_strategy: random:50%
MMC4_datasets:
  - json_path: {mmc4_dir}
""")
    for group in ("QA_datasets", "SCANQA_datasets", "MMC4_datasets"):
        assert tco.load_mixture_entries(yaml_path, group, seed=3) == \
            jco.load_mixture_entries(yaml_path, group, seed=3)
    roots = {"qa": media_tree, "scanqa": media_tree, "mmc4": media_tree}
    t_sets = tco.build_cotraining_datasets(ByteTokenizer(), t_tiny(),
                                           yaml_path, media_roots=roots)
    j_sets = jco.build_cotraining_datasets(JByteTokenizer(), j_tiny(),
                                           yaml_path, media_roots=roots)
    assert [(len(d), d.task_id) for d in t_sets] == \
        [(len(d), d.task_id) for d in j_sets] == [(4, 1), (2, 2), (1, 3)]
    for t_ds, j_ds in zip(t_sets, j_sets):
        for i in range(len(t_ds)):
            _same_sample(t_ds[i], j_ds[i])
    assert sorted(set(CombineDataset(t_sets).task_ids)) == [1, 2, 3]


# ---------------------------------------------------------------------------
# remote
# ---------------------------------------------------------------------------

def test_local_and_file_scheme(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"hello")
    for mod in (tremote, jremote):
        assert mod.read_bytes(str(p)) == b"hello"
        assert mod.read_bytes("file://" + str(p)) == b"hello"
        assert not mod.is_remote(str(p))
        assert mod.is_remote("s3://bucket/key")
        assert mod.is_remote("https://host/x.json")
        with pytest.raises(ValueError, match="unsupported"):
            mod.read_bytes("gopher://host/x")


def test_s3_and_petrel_gated_like_reference(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setitem(sys.modules, "petrel_client", None)
    monkeypatch.setitem(sys.modules, "petrel_client.client", None)
    for mod in (tremote, jremote):
        with pytest.raises(ImportError, match="boto3"):
            mod.read_bytes("s3://bucket/key")
        with pytest.raises(ImportError, match="petrel_client"):
            mod.read_bytes("petrel://bucket/key")


def test_registry_mixture_shard_and_open_image(tmp_path):
    """A registered scheme serves a mixture's json shard and an image, in
    both packages."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 6, 3), 7, np.uint8)).save(buf, "PNG")
    entries = [{"id": i, "conversations": []} for i in range(3)]
    blobs = {"myfs://shards/q.json": json.dumps(entries).encode(),
             "myfs://img/x.png": buf.getvalue()}
    yml = tmp_path / "mix.yaml"
    yml.write_text("QA_datasets:\n"
                   "  - json_path: myfs://shards/q.json\n"
                   "    sampling_strategy: all\n")
    for mod, co in ((tremote, tco), (jremote, jco)):
        mod.register_scheme("MyFS", lambda uri: blobs[uri])
        try:
            assert co.load_mixture_entries(str(yml), "QA_datasets") == \
                entries
            img = mod.open_image("myfs://img/x.png")
            assert img.size == (6, 8) and img.mode == "RGB"
        finally:
            mod._OPENERS.pop("myfs", None)


# ---------------------------------------------------------------------------
# conversation templates
# ---------------------------------------------------------------------------

def test_every_conversation_template_matches_jax():
    assert set(tconv.conv_templates) == set(jconv.conv_templates)
    assert [s.value for s in tconv.SeparatorStyle] == \
        [s.value for s in jconv.SeparatorStyle]
    for name in jconv.conv_templates:
        prompts = []
        for mod in (tconv, jconv):
            conv = mod.conv_templates[name].copy()
            conv.append_message(conv.roles[0], "<image>\nWhere now?")
            conv.append_message(conv.roles[1], "Turn left.")
            conv.append_message(conv.roles[0], "And then?")
            conv.append_message(conv.roles[1], None)
            prompts.append((conv.get_prompt(), conv.version, conv.sep,
                            conv.sep2))
            assert mod.conv_templates[name].messages == [] or \
                mod.conv_templates[name].messages is not conv.messages
        assert prompts[0] == prompts[1], name
    assert tconv.default_conversation.get_prompt() == \
        jconv.default_conversation.get_prompt()


# ---------------------------------------------------------------------------
# the training state's checkpoints
# ---------------------------------------------------------------------------

def _state(seed: int):
    """A TrainState whose params hold bf16, int8 and packed int4 leaves
    and LoRA adapters, with accumulation on (so the accumulator and its
    micro-step count are part of the state); values made from `seed`."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    q8, s8 = tquant.quantize_weight(rnd(64, 32))
    q4, s4 = tquant.quantize_weight_int4(rnd(128, 16))
    params = {"vision": {"patch_w": rnd(12, 8).to(torch.bfloat16)},
              "projector": {"layers": [{"w": rnd(8, 4), "b": rnd(4)}]},
              "llm": {"embed": rnd(10, 4).to(torch.bfloat16),
                      "layers": {"q_w": q8[None], "q_w_scale": s8[None],
                                 "down_w": q4[None],
                                 "down_w_scale": s4[None],
                                 "q_w_lora_a": rnd(1, 64, 2),
                                 "q_w_lora_b": rnd(1, 2, 32)},
                      "lora_scale": torch.tensor(2.0)}}
    state = create_train_state(params, TrainConfig(lora_only=True,
                                                   grad_accum_steps=3))
    opt = state.opt_state
    opt["mini_step"] = seed % 3
    for t in opt["acc"].values():
        t.copy_(rnd(*t.shape))
    for grp in opt["groups"].values():
        grp["count"] = seed
        for t in list(grp["mu"].values()) + list(grp["nu"].values()):
            t.copy_(rnd(*t.shape))
    return TrainState(step=seed, params=params, opt_state=opt)


def _flat_state(state):
    return dict(tree_leaves({"step": state.step, "params": state.params,
                             "opt": state.opt_state}))


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    d = str(tmp_path / "ckpt")
    saved = _state(7)
    assert tck.save_checkpoint(d, saved, 7)
    assert tck.latest_step(d) == 7 and os.listdir(d) == ["7"]
    target = _state(4)
    restored, step = tck.resume_latest(d, target)
    assert step == 7 and restored.step == 7
    assert restored.opt_state["mini_step"] == 1
    want = _flat_state(saved)
    got = _flat_state(restored)
    assert set(got) == set(want)
    for p, v in want.items():
        if isinstance(v, torch.Tensor):
            assert got[p].dtype == v.dtype and torch.equal(got[p], v), p
        else:
            assert got[p] == v, p
    # restored in place, on the target's tensors
    assert restored.params["llm"]["layers"]["down_w"] is \
        target.params["llm"]["layers"]["down_w"]
    assert restored.params["llm"]["layers"]["down_w"].dtype == torch.uint8
    # a target of another shape or dtype is refused
    bad = _state(4)
    bad.params["vision"]["patch_w"] = bad.params["vision"]["patch_w"].float()
    with pytest.raises(ValueError, match="patch_w"):
        tck.restore_checkpoint(d, bad)


def test_checkpoint_keeps_newest_and_ignores_cut_saves(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 4, 5):
        assert tck.save_checkpoint(d, _state(step), step)
    assert sorted(os.listdir(d)) == ["3", "4", "5"]
    assert tck.save_checkpoint(d, _state(6), 6, max_to_keep=2)
    assert sorted(os.listdir(d)) == ["5", "6"]
    # a save cut before its rename leaves a name that is not all digits
    os.makedirs(os.path.join(d, ".tmp-9"))
    os.makedirs(os.path.join(d, "8.orbax-checkpoint-tmp-1"))
    assert tck.latest_step(d) == jck.latest_step(d) == 6
    restored, step = tck.resume_latest(d, _state(1))
    assert step == 6 and restored.opt_state["groups"]["lora"]["count"] == 6
    # the next save clears its own leftovers, never another name
    assert tck.save_checkpoint(d, _state(7), 7)
    assert sorted(os.listdir(d)) == ["5", "6", "7",
                                     "8.orbax-checkpoint-tmp-1"]


def test_empty_directory_resumes_at_zero(tmp_path):
    state = _state(2)
    for d in (str(tmp_path / "missing"), str(tmp_path)):
        got, step = tck.resume_latest(d, state)
        assert step == 0 and got is state
        assert tck.latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            tck.restore_checkpoint(d, state)


def test_step_saved_twice_behaves_as_orbax(tmp_path):
    """orbax's CheckpointManager (the reference's saver) skips a save of a
    step at or below the newest on disk and keeps what is there; the port
    does the same. Checked on orbax itself through the JAX package."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    first = {"a": jnp.ones(3)}
    jck.save_checkpoint(jd, first, 6, wait=True)
    jck.save_checkpoint(jd, {"a": jnp.zeros(3)}, 6, wait=True)
    jck.save_checkpoint(jd, {"a": jnp.zeros(3)}, 2, wait=True)
    assert jck.latest_step(jd) == 6 and sorted(os.listdir(jd)) == ["6"]
    np.testing.assert_array_equal(
        jck.restore_checkpoint(jd, first, 6)["a"], np.ones(3))

    assert tck.save_checkpoint(td, _state(6), 6)
    assert not tck.save_checkpoint(td, _state(5), 6)
    assert not tck.save_checkpoint(td, _state(5), 2)
    assert sorted(os.listdir(td)) == ["6"]
    restored = tck.restore_checkpoint(td, _state(1))
    assert restored.step == 6
    assert torch.equal(restored.params["projector"]["layers"][0]["w"],
                       _state(6).params["projector"]["layers"][0]["w"])
