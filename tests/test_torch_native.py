"""The port's native host runtime (`streamvln_tpu_torch/native/`, its own
copies of the C++ sources, built into `streamvln_tpu_torch/_build/`)
against the JAX package's library: the subjects of tests/test_native.py,
each on the same inputs through both libraries, which must agree bit for
bit, and the reference test's own bounds against PIL. The tests skip only
where the reference's do: a library that does not build here (no
jpeglib.h, no libav headers) and no cv2 to write a test video.
"""
import io
import os

import numpy as np
import pytest

from streamvln_tpu import native as jnative
from streamvln_tpu_torch import native


@pytest.fixture
def jpeg():
    if not native.available():
        pytest.skip(f"native build unavailable: {native.build_error()}")
    assert jnative.available(), jnative.build_error()


@pytest.fixture
def video(jpeg):
    if not native.video_available():
        pytest.skip(f"libav unavailable: {native.video_build_error()}")
    assert jnative.video_available(), jnative.video_build_error()


def test_the_libraries_build_outside_the_sources(jpeg):
    """Built into the port's _build directory under a hash of the source,
    never beside the sources or into the JAX package."""
    path = native._jpeg.path()
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.exists(path)
    assert not [f for f in os.listdir(os.path.dirname(native.__file__))
                if f.endswith(".so")]


def test_decode_jpeg_roundtrip(jpeg):
    from PIL import Image
    y, x = np.mgrid[0:60, 0:80]
    img = np.stack([x * 3 % 256, y * 4 % 256, (x + y) % 256],
                   -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    decoded = native.decode_jpeg(buf.getvalue())
    assert decoded.shape == (60, 80, 3)
    np.testing.assert_array_equal(decoded, jnative.decode_jpeg(buf.getvalue()))
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
    assert np.abs(decoded.astype(int) - pil.astype(int)).max() <= 1


def test_decode_garbage_raises(jpeg):
    for lib in (native, jnative):
        with pytest.raises(ValueError):
            lib.decode_jpeg(b"definitely not a jpeg")


@pytest.mark.parametrize("shape,size", [((3, 120, 160, 3), 64),
                                        ((1, 16, 16, 3), 64)])
def test_preprocess_matches_the_reference_and_pil(jpeg, shape, size):
    """Downscale and the upscale path: the port's fused bicubic + normalize
    equals the reference library's and stays within the reference test's
    bounds of the PIL host path."""
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames_host
    frames = np.random.RandomState(1).randint(0, 255, shape, np.uint8)
    ours = native.preprocess_batch(frames, size=size)
    np.testing.assert_array_equal(ours,
                                  jnative.preprocess_batch(frames, size))
    diff = np.abs(ours - preprocess_frames_host(frames, size=size))
    assert diff.mean() < 0.01 and diff.max() < 0.08


def test_load_preprocess_jpegs(jpeg, tmp_path):
    from PIL import Image
    rng = np.random.RandomState(2)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.jpg")
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
            p, quality=95)
        paths.append(p)
    out = native.load_preprocess_jpegs(paths, size=32)
    assert out.shape == (4, 32, 32, 3) and np.isfinite(out).all()
    assert -1.01 <= out.min() and out.max() <= 1.01
    np.testing.assert_array_equal(out, jnative.load_preprocess_jpegs(paths,
                                                                     32))


def test_load_missing_file_reports(jpeg):
    with pytest.raises(RuntimeError, match="failed"):
        native.load_preprocess_jpegs(["/nonexistent/x.jpg"], size=32)


def test_resize_batch_u8_pil_parity(jpeg):
    from PIL import Image
    frames = np.random.RandomState(7).randint(0, 255, (3, 48, 64, 3),
                                              np.uint8)
    out = native.resize_batch_u8(frames, 32)
    assert out.shape == (3, 32, 32, 3) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jnative.resize_batch_u8(frames, 32))
    pil = np.stack([np.asarray(Image.fromarray(f).resize(
        (32, 32), Image.BICUBIC)) for f in frames])
    assert np.abs(out.astype(int) - pil.astype(int)).max() <= 1
    with pytest.raises(ValueError, match=r"\[N, H, W, 3\]"):
        native.resize_batch_u8(frames[..., :2], 32)


def _write_test_video(path, n_frames=30, w=64, h=48, fps=10):
    cv2 = pytest.importorskip("cv2")
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    assert wr.isOpened()
    for i in range(n_frames):
        img = np.full((h, w, 3), i * 8 % 256, np.uint8)
        img[:, : w // 8] = (255, 0, 0)          # BGR blue stripe
        wr.write(img)
    wr.release()


def test_video_info_and_sampling(video, tmp_path):
    p = str(tmp_path / "clip.mp4")
    _write_test_video(p, n_frames=30)
    info = native.video_info(p)
    assert info == jnative.video_info(p)
    w, h, fps, n = info
    assert (w, h, n) == (64, 48, 30) and fps == pytest.approx(10.0, rel=0.1)
    frames = native.video_sample_frames(p, frames_upbound=8,
                                        force_sample=True)
    assert frames.shape == (8, 48, 64, 3)
    np.testing.assert_array_equal(frames, jnative.video_sample_frames(
        p, frames_upbound=8, force_sample=True))
    assert frames[0, 0, 0, 2] > 180 and frames[0, 0, 0, 0] < 60
    mids = frames[:, 24, 40, 1].astype(int)
    assert mids[-1] > mids[0] + 80
    picked = native.video_read_frames(p, [0, 10, 29])
    np.testing.assert_array_equal(picked,
                                  jnative.video_read_frames(p, [0, 10, 29]))
    with pytest.raises(ValueError, match="outside"):
        native.video_read_frames(p, [30])


def test_conversation_dataset_consumes_video_file(video, tmp_path):
    """The co-training dataset samples a video file through the native
    decoder: the port's sample equals the JAX package's."""
    from streamvln_tpu.configs import tiny_streamvln as j_tiny
    from streamvln_tpu.data.cotrain_datasets import \
        ConversationDataset as JDataset
    from streamvln_tpu.data.tokenizer import ByteTokenizer as JTok
    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.cotrain_datasets import ConversationDataset
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer

    _write_test_video(tmp_path / "clip.mp4", n_frames=20)
    entry = {"id": 0, "video": "clip.mp4", "conversations": [
        {"from": "human", "value": "What color is the stripe?"},
        {"from": "gpt", "value": "Blue."}]}
    got = ConversationDataset(ByteTokenizer(), tiny_streamvln(), [entry],
                              str(tmp_path), num_frames_qa=4)[0]
    want = JDataset(JTok(), j_tiny(), [entry], str(tmp_path),
                    num_frames_qa=4)[0]
    S = tiny_streamvln().vision.image_size
    assert got["images"].shape == (4, S, S, 3)
    assert got["images"].dtype == np.float32
    assert (got["input_ids"] == -200).sum() == 4
    assert got["time_ids"].tolist() == [0, 1, 2, 3]
    for k in ("input_ids", "labels", "time_ids", "images"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_env_worker_resize_takes_the_native_path(jpeg, monkeypatch):
    """eval/env_workers.resize_rgb_transform resizes through the native
    library, as the reference's does, and through PIL where it does not
    build: the same frames either way, and the reference's."""
    from streamvln_tpu.eval import env_workers as jworkers
    from streamvln_tpu_torch.eval import env_workers
    rgb = np.random.RandomState(4).randint(0, 255, (48, 64, 3), np.uint8)
    got = env_workers.resize_rgb_transform(32)({"rgb": rgb, "x": 1})
    np.testing.assert_array_equal(
        got["rgb"], jworkers.resize_rgb_transform(32)({"rgb": rgb})["rgb"])
    assert got["x"] == 1
    monkeypatch.setattr(native, "available", lambda: False)
    pil = env_workers.resize_rgb_transform(32)({"rgb": rgb})["rgb"]
    assert np.abs(pil.astype(int) - got["rgb"].astype(int)).max() <= 1
