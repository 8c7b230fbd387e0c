"""The port's training entry point (`streamvln_tpu_torch.train.main`)
against the JAX package's (`streamvln_tpu.train.main`) on the CPU, on the
same synthetic trajectory tree, tiny configs, `--dp 1 --fsdp 1`.

Both packages' random init is patched to return the same JAX init
(carried across by `weights.from_jax_params`), and the port's `add_lora`
to draw JAX's adapters, so the two commands start from the same params;
data, sampler order and tokenizer are the same code in both (the JAX
side's C++ JPEG loader is switched off: the port reads JPEGs with PIL,
whose decode differs in the last bits). Compared:
the train_log.jsonl lines step by step (loss and grad_norm at the repo's
gradient gate, rtol 2e-4 / atol 2e-5, tests/test_parallel.py:100-101),
the metrics.jsonl mirror, the final params (same gate), `latest_step`,
resume (into the middle of an accumulation), a JAX orbax checkpoint
continued in the port, the mid-training eval line, and the exports
against JAX's `export_hf` dict (not JAX's files: its `save_hf` scrambles
transposed matrices, ROADMAP §3.5). `--bits 4` runs in the port alone:
JAX's CLI cannot add adapters to a packed int4 base (§3.5).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import native as jnative
from streamvln_tpu import train as jtrain_cli
from streamvln_tpu.data.vln_dataset import (write_annotations,
                                            write_trajectory)
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu.utils import checkpoint as jck
from streamvln_tpu_torch import train as ttrain_cli
from streamvln_tpu_torch import weights as tweights
from streamvln_tpu_torch.models import lora as tlora
from streamvln_tpu_torch.models import quant as tquant
from streamvln_tpu_torch.models.quant import is_packed_int4
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.utils import checkpoint as tck
from streamvln_tpu_torch.utils import safetensors_io

ATOL, RTOL = 2e-5, 2e-4
TINY = ["--model_size", "tiny", "--num_frames", "8",
        "--num_future_steps", "2", "--num_history", "2",
        "--batch_size", "2", "--log_steps", "1", "--dp", "1",
        "--fsdp", "1", "--learning_rate", "1e-3"]


@pytest.fixture(scope="module")
def traj_root(tmp_path_factory):
    """tests/test_train_entry.py's tree: 3 episodes of 10 steps."""
    root = str(tmp_path_factory.mktemp("traj"))
    rng = np.random.RandomState(0)
    entries = []
    for ep in range(3):
        frames = rng.randint(0, 255, (10, 48, 64, 3), np.uint8)
        entries.append(write_trajectory(
            root, f"scene_{ep}", frames, [f"instr {ep}"],
            rng.randint(0, 4, 10).tolist()))
    write_annotations(root, entries)
    return root


@pytest.fixture(scope="module")
def init_params(traj_root):
    """(JAX config, JAX init as numpy) of the tiny CLI configuration."""
    args = jtrain_cli.build_argparser().parse_args(
        ["--video_folders", traj_root, "--output_dir", "unused"] + TINY)
    jc = jtrain_cli.build_config(args)
    return jc, jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0), jc))


@pytest.fixture
def shared(init_params, monkeypatch):
    """Both CLIs start from the JAX init; the port's adapters are JAX's
    (add_lora draws them from PRNGKey(seed + 1), seed 0)."""
    jc, npp = init_params
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(jsv, "init", lambda key, cfg, dtype=jnp.float32:
                        jax.tree.map(lambda x: jnp.asarray(x, dtype)
                                     if x.dtype.kind == "f"
                                     else jnp.asarray(x), npp))
    monkeypatch.setattr(
        tweights, "init", lambda cfg, generator=None, device="cuda",
        dtype=torch.bfloat16: tweights.from_jax_params(
            npp, cfg, device=device, dtype=dtype))
    add = tlora.add_lora

    def add_lora(params, generator, rank=16, alpha=32.0, **kw):
        out = add(params, generator, rank=rank, alpha=alpha, **kw)
        layers = out["llm"]["layers"]
        shapes = {n[:-len("_lora_a")]: layers[n[:-len("_lora_a")]]
                  for n in layers if n.endswith("_lora_a")}
        fake = {"llm": {"layers": {
            n: jnp.zeros((w.shape[0], w.shape[1] * (1 + is_packed_int4(w)),
                          w.shape[2])) for n, w in shapes.items()}}}
        j = jlora.add_lora(fake, jax.random.PRNGKey(1), jc.llm, rank=rank,
                           alpha=alpha)["llm"]["layers"]
        for n in shapes:
            layers[n + "_lora_a"].copy_(torch.from_numpy(
                np.asarray(j[n + "_lora_a"])))
        return out
    monkeypatch.setattr(tlora, "add_lora", add_lora)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    return jc, npp


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _flat(tree):
    return {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _same_logs(jout, tout, rtol=None):
    """Same steps, keys, losses and grad norms; `rtol` {key: rtol} widens
    the gate where int8 activations round (act_int8)."""
    jl, tl = _log(jout), _log(tout)
    assert [r["step"] for r in tl] == [r["step"] for r in jl]
    for j, t in zip(jl, tl):
        assert set(t) == set(j)
        for k in ("loss", "grad_norm"):
            if k in j:
                assert np.isfinite(t[k])
                np.testing.assert_allclose(
                    t[k], j[k], rtol=(rtol or {}).get(k, RTOL), atol=ATOL,
                    err_msg=f"step {j['step']} {k}")
    return jl, tl


def _same_params(jstate, tstate, atol=ATOL):
    want = _flat(jstate.params)
    got = {p: t.detach().numpy() for p, t in
           ttrain.tree_leaves(tstate.params)}
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL, atol=atol,
                                   err_msg=p)


def _same_export(path, want: dict, atol=ATOL):
    got = safetensors_io.load_file(os.path.join(path, "model.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=RTOL, atol=atol,
                                   err_msg=k)


def test_train_cli_matches_jax(traj_root, tmp_path, shared):
    """Full SFT, 3 steps, checkpoints at 2 and 3, the HF export."""
    jc, _ = shared
    argv = ["--num_steps", "3", "--save_steps", "2", "--export_hf",
            "--report_to", "wandb"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jstate = jtrain_cli.main(["--video_folders", traj_root, "--output_dir",
                              jout] + TINY + argv)
    tstate = ttrain_cli.main(["--video_folders", traj_root, "--output_dir",
                              tout] + TINY + argv + ["--device", "cpu"])
    assert tstate.step == int(jstate.step) == 3
    _same_logs(jout, tout)
    with open(os.path.join(tout, "metrics.jsonl")) as f:
        mirror = [json.loads(line) for line in f]
    assert [r["step"] for r in mirror] == [1, 2, 3]
    for r, j in zip(mirror, _log(jout)):
        np.testing.assert_allclose(r["loss"], j["loss"], rtol=RTOL,
                                   atol=ATOL)
    _same_params(jstate, tstate)
    assert tck.latest_step(os.path.join(tout, "ckpt")) == \
        jck.latest_step(os.path.join(jout, "ckpt")) == 3
    assert sorted(os.listdir(os.path.join(tout, "ckpt"))) == ["2", "3"]
    _same_export(os.path.join(tout, "hf_export"),
                 jck.export_hf(jax.device_get(jstate.params), jc))


def test_train_cli_resume_matches_jax(traj_root, tmp_path, shared):
    """3 micro-steps, then a run to 4 from the step-3 checkpoint: with
    --grad_accum_steps 2 the restore lands between the two micro-steps of
    an optimizer step, so the accumulator and its count must come back.
    No run saves its last step in the loop: the JAX CLI's asynchronous
    save of it would race its final save of the same step (ROADMAP
    §3.7)."""
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--grad_accum_steps", "2"]
    for n, every in (("3", "2"), ("4", "5")):
        extra = ["--num_steps", n, "--save_steps", every]
        jstate = jtrain_cli.main(["--video_folders", traj_root,
                                  "--output_dir", jout] + TINY + argv
                                 + extra)
        tstate = ttrain_cli.main(["--video_folders", traj_root,
                                  "--output_dir", tout] + TINY + argv
                                 + extra + ["--device", "cpu"])
        if n == "3":
            assert tstate.opt_state["mini_step"] == 1
    jl, tl = _same_logs(jout, tout)
    assert [r["step"] for r in tl] == [1, 2, 3, 4]
    assert tstate.step == int(jstate.step) == 4
    assert tstate.opt_state["mini_step"] == 0
    _same_params(jstate, tstate)
    assert sorted(os.listdir(os.path.join(tout, "ckpt"))) == ["2", "3", "4"]


def test_jax_checkpoint_continued_in_the_port(traj_root, tmp_path, shared):
    """A JAX run's orbax checkpoint (step 3, mid-accumulation), restored by
    JAX's own restore_checkpoint, carried over with from_jax_train_state,
    saved by the port and continued by the port's CLI; against JAX's
    continuation of the same checkpoint."""
    jc, npp = shared
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--grad_accum_steps", "2", "--save_steps", "2", "--lora_enable",
            "--lora_r", "4"]
    common = ["--video_folders", traj_root] + TINY + argv
    jtrain_cli.main(common + ["--output_dir", jout, "--num_steps", "3"])
    kw = dict(learning_rate=1e-3, total_steps=3, grad_accum_steps=2,
              lora_only=True, warmup_ratio=0.03)
    target = jtrain.create_train_state(jlora.add_lora(
        jax.tree.map(jnp.asarray, npp), jax.random.PRNGKey(1), jc.llm,
        rank=4), jtrain.TrainConfig(**kw))
    restored = jax.tree.map(np.asarray, jck.restore_checkpoint(
        os.path.join(jout, "ckpt"), target, 3))
    tc = ttrain_cli.configs.build_config(
        ttrain_cli.build_argparser().parse_args(
            ["--video_folders", traj_root, "--output_dir", tout] + TINY))
    port = tweights.from_jax_train_state(restored, tc,
                                         ttrain.TrainConfig(**kw),
                                         device="cpu")
    assert port.step == 3 and port.opt_state["mini_step"] == 1
    assert tck.save_checkpoint(os.path.join(tout, "ckpt"), port, 3)

    jstate = jtrain_cli.main(common + ["--output_dir", jout,
                                       "--num_steps", "5"])
    tstate = ttrain_cli.main(common + ["--output_dir", tout,
                                       "--num_steps", "5",
                                       "--device", "cpu"])
    jl = [r for r in _log(jout) if r["step"] > 3]
    tl = _log(tout)
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == [4, 5]
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=RTOL, atol=ATOL)
    _same_params(jstate, tstate)


def test_mid_training_eval_line_matches_jax(traj_root, tmp_path, shared):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--num_steps", "2", "--save_steps", "10", "--eval_steps", "2",
            "--eval_episodes", "2"]
    _run_pair = [(jtrain_cli.main, jout, []),
                 (ttrain_cli.main, tout, ["--device", "cpu"])]
    for main, out, extra in _run_pair:
        main(["--video_folders", traj_root, "--output_dir", out] + TINY
             + argv + extra)
    jev, tev = ([r for r in _log(out) if any(k.startswith("eval/")
                                             for k in r)]
                for out in (jout, tout))
    assert len(jev) == len(tev) == 1 and tev[0]["step"] == 2
    assert set(tev[0]) == set(jev[0])
    for k, v in jev[0].items():
        if k.startswith("eval/model_call"):     # wall-clock latencies
            continue
        np.testing.assert_allclose(tev[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert "eval/sucs_all" in tev[0] and "eval/spls_all" in tev[0]


def test_lora_int8_act_int8_matches_jax(traj_root, tmp_path, shared):
    """--lora_enable --bits 8 --act_int8 --export_hf: the int8 base stays
    bit-equal, the adapters npz and the merged export (into dequantized
    weights) equal JAX's."""
    jc, npp = shared
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--num_steps", "2", "--save_steps", "10", "--lora_enable",
            "--lora_r", "4", "--bits", "8", "--act_int8", "--export_hf"]
    jstate = jtrain_cli.main(["--video_folders", traj_root, "--output_dir",
                              jout] + TINY + argv)
    tstate = ttrain_cli.main(["--video_folders", traj_root, "--output_dir",
                              tout] + TINY + argv + ["--device", "cpu"])
    # an activation an f32 ulp from a rounding boundary can take the
    # neighbouring int8 code: tests/test_torch_act_int8.py's train-step
    # gates (loss rtol 1e-4, grad norm rtol 2e-3)
    _same_logs(jout, tout, rtol={"loss": 1e-4, "grad_norm": 2e-3})
    layers = tstate.params["llm"]["layers"]
    assert layers["q_w"].dtype == torch.int8 and "q_w_lora_a" in layers
    base = _flat(jquant.quantize_llm(jax.tree.map(jnp.asarray, npp),
                                     bits=8))
    for p, t in ttrain.tree_leaves(tstate.params):
        if t.dtype == torch.int8 or (p.endswith("_scale")
                                     and not tlora.is_lora_path(p)):
            np.testing.assert_array_equal(t.numpy(), base[p], err_msg=p)
    # Adam's update is the ratio of the moments: where an element's two
    # micro-gradients nearly cancel, gradients 2e-3 apart (act_int8's gate
    # in tests/test_torch_act_int8.py) move it by a share of the lr
    # (1e-3); the adapters are held to a tenth of the lr
    _same_params(jstate, tstate, atol=1e-4)
    # JAX's dequantize_llm drops lora_scale with the int8 scales, so its
    # npz holds None for it and its merge adds nothing (ROADMAP §3.7): the
    # port keeps the scale, and its export is the merge the reference's
    # comment asks for, computed here by JAX's own functions
    with np.load(os.path.join(jout, "lora_adapters.npz")) as j, \
            np.load(os.path.join(tout, "lora_adapters.npz")) as t:
        assert set(t.files) == set(j.files)
        assert any(k.endswith("_lora_a") for k in t.files)
        for k in j.files:
            if k != "lora_scale":
                np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=1e-4,
                                           err_msg=k)
        assert t["lora_scale"] == np.float32(32.0 / 4)
    final = jax.device_get(jstate.params)
    dq = jquant.dequantize_llm(final)
    merged = jlora.merge_lora(dict(dq, llm=dict(
        dq["llm"], lora_scale=final["llm"]["lora_scale"])))
    _same_export(os.path.join(tout, "hf_export"), jck.export_hf(merged, jc),
                 atol=1e-4 * 32.0 / 4)


def test_lora_int4_port_alone(traj_root, tmp_path, shared):
    """--lora_enable --bits 4 (QLoRA through the CLI): the packed leaves
    and their scales bit-equal to quantize_llm of the init, finite losses,
    adapters that moved, and the export of the adapters merged into the
    dequantized tree."""
    jc, npp = shared
    out = str(tmp_path / "port")
    state = ttrain_cli.main(["--video_folders", traj_root, "--output_dir",
                             out] + TINY + [
        "--num_steps", "2", "--save_steps", "10", "--lora_enable",
        "--lora_r", "4", "--bits", "4", "--export_hf", "--device", "cpu"])
    tc = ttrain_cli.configs.build_config(
        ttrain_cli.build_argparser().parse_args(
            ["--video_folders", traj_root, "--output_dir", out] + TINY))
    base = dict(ttrain.tree_leaves(tquant.quantize_llm(
        tweights.from_jax_params(npp, tc, device="cpu"), bits=4)))
    packed = 0
    for p, t in ttrain.tree_leaves(state.params):
        if is_packed_int4(t) or (p.endswith("_scale")
                                 and not tlora.is_lora_path(p)):
            packed += is_packed_int4(t)
            assert torch.equal(t, base[p]), p
    assert packed == 8              # 7 projections + the lm_head
    assert all(np.isfinite(r["loss"]) for r in _log(out))
    assert state.params["llm"]["layers"]["q_w_lora_b"].abs().sum() > 0
    with torch.no_grad():
        merged = tlora.merge_lora(tquant.dequantize_llm(state.params))
        want = tck.export_hf(merged, tc)
    got = safetensors_io.load_file(os.path.join(out, "hf_export",
                                                "model.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("argv,exc,match", [
    (["--bits", "8"], SystemExit, "--bits 8 requires --lora_enable"),
    (["--bits", "4"], SystemExit, "--bits 4 requires --lora_enable"),
    (["--lora_enable", "--act_int8"], SystemExit,
     "--act_int8 requires --bits 8"),
    (["--fsdp", "2"], NotImplementedError, "item 8"),
    (["--dp", "2"], NotImplementedError, "item 8"),
    (["--tp", "2"], NotImplementedError, "item 8"),
    (["--model_size", "llama2-7b"], NotImplementedError, "item 10"),
])
def test_refusals(traj_root, tmp_path, argv, exc, match):
    """The reference's SystemExits word for word (JAX's own are checked on
    the same arguments); a mesh of more than one device names ROADMAP item
    8, another LLM family item 10."""
    common = ["--video_folders", traj_root, "--output_dir",
              str(tmp_path)] + TINY
    with pytest.raises(exc, match=match) as got:
        ttrain_cli.main(common + argv + ["--device", "cpu"])
    if exc is SystemExit:
        with pytest.raises(SystemExit) as want:
            jtrain_cli.main(common + argv)
        assert str(got.value) == str(want.value)


def test_no_card_raises(traj_root, tmp_path, monkeypatch):
    """Without --device cpu the command asks for the card; with none it
    raises, it does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(["--video_folders", traj_root, "--output_dir",
                         str(tmp_path)] + TINY)
