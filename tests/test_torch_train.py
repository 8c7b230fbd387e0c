"""The port's training slice against the JAX package on the CPU in
float32: LoRA adapters, `forward_train` (loss and the gradient of every
leaf, full and chunked cross-entropy, with and without remat), a
multi-step `make_train_step` trajectory, and the data pipeline (VLN
windows and `collate`).

The decoder runs at head_dim 128 with T >= 64 so that the port's flash
training path (`_FlashAttentionFn`, the plain versions of K3/K4/K5 on the
CPU) is reached; the JAX side uses `attn_impl="dense"` (its flash path is
TPU-only), and the tower's attention goes through K1's wrapper and its
torch-math backward. Weights are the JAX init's, carried across by
`weights.from_jax_params`; inputs are made with numpy from fixed seeds.
Tolerance rtol 2e-4, atol 2e-5 (tests/test_parallel.py:100-101): f32 sums
in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.data import collate as jcollate
from streamvln_tpu.data import vln_dataset as jvln
from streamvln_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import collate as tcollate
from streamvln_tpu_torch.data import vln_dataset as tvln
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import lora as tlora
from streamvln_tpu_torch.models import streamvln as tsv
from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL, RTOL = 2e-5, 2e-4
IMAGE, IGNORE = -200, -100


def _cfgs():
    """tiny_streamvln with a head_dim-128 decoder (GQA 2/1)."""
    jc = jcfg.tiny_streamvln()
    jc = dataclasses.replace(jc, llm=dataclasses.replace(
        jc.llm, num_heads=2, num_kv_heads=1, head_dim=128))
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        **{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
           if f.name not in ("vision", "llm")})
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(cfg, seed, B=2, T=128):
    """Two samples of different lengths with <image> frames and labels on
    the answer tokens, padded to T; images [B, 2, S, S, 3]."""
    rng = np.random.default_rng(seed)
    layouts = []
    for n in (40, 70)[:B]:
        ids = np.concatenate([[7, IMAGE, 9, IMAGE],
                              rng.integers(3, 500, n)]).astype(np.int32)
        labels = np.where(np.arange(len(ids)) > len(ids) // 2, ids, IGNORE)
        layouts.append(jsv.build_splice_layout(ids, cfg, labels=labels,
                                               pad_to=T))
    batch = jsv.stack_layouts(layouts)
    del batch["lengths"]
    S = cfg.vision.image_size
    batch["images"] = rng.standard_normal((B, 2, S, S, 3)).astype(np.float32)
    return batch


def _t_layout(batch):
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in
            ("token_ids", "is_vision", "vision_index", "labels", "valid")}


@pytest.fixture(scope="module")
def stack():
    jc, tc = _cfgs()
    return jc, tc, jsv.init(jax.random.PRNGKey(0), jc)


def test_lora_add_merge_split_match_jax(stack, tmp_path):
    jc, tc, jp = stack
    jl = jlora.add_lora(jp, jax.random.PRNGKey(1), jc.llm, rank=4,
                        alpha=8.0)
    tp = from_jax_params(_np(jp), tc, device="cpu")
    tl = tlora.add_lora(tp, torch.Generator().manual_seed(1), rank=4,
                        alpha=8.0)
    # same leaves, shapes and dtypes as JAX; B = 0, A ~ N(0, 1/din)
    jflat = _flat(jl)
    tflat = {p: t.numpy() for p, t in ttrain.tree_leaves(tl)}
    assert {p: (a.shape, a.dtype) for p, a in jflat.items()} == \
        {p: (a.shape, a.dtype) for p, a in tflat.items()}
    assert not tl["llm"]["layers"]["down_w_lora_b"].any()
    a = tl["llm"]["layers"]["gate_w_lora_a"]
    assert abs(a.std().item() * a.shape[1] ** 0.5 - 1.0) < 0.2
    assert tl["llm"]["layers"]["q_w"] is tp["llm"]["layers"]["q_w"]

    # merge/split on JAX's adapters with nonzero B, carried across
    rng = np.random.default_rng(2)
    jl = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        if "_lora_b" in jmesh._path_str(p) else x, jl)
    tl = from_jax_params(_np(jl), tc, device="cpu")
    assert tl["llm"]["layers"]["q_w_lora_a"].dtype == torch.float32
    jm, tm = _flat(jlora.merge_lora(jl)), tlora.merge_lora(tl)
    tm = {p: t.numpy() for p, t in ttrain.tree_leaves(tm)}
    assert set(jm) == set(tm)
    for p in jm:
        np.testing.assert_allclose(tm[p], jm[p], atol=1e-5, rtol=1e-5,
                                   err_msg=p)
    (jb, ja), (tb, ta) = jlora.split_lora(jl), tlora.split_lora(tl)
    assert set(_flat(jb)) == {p for p, _ in ttrain.tree_leaves(tb)}
    assert set(ja["layers"]) == set(ta["layers"])
    # adapters exported as the JAX trainer's npz attach back
    np.savez(tmp_path / "ad.npz", lora_scale=np.asarray(ja["lora_scale"]),
             **{k: np.asarray(v) for k, v in ja["layers"].items()})
    back = tlora.apply_adapters_npz(tb, str(tmp_path / "ad.npz"))
    for k, v in ta["layers"].items():
        torch.testing.assert_close(back["llm"]["layers"][k], v)
    assert tlora.is_lora_path("llm/layers/q_w_lora_a") and \
        tlora.is_lora_path("llm/lora_scale") and \
        not tlora.is_lora_path("llm/layers/q_w")
    # adapters fold into int8 weights by dequantize, add, requantize (it
    # raised before the quantized tail), bit for bit the reference's
    from streamvln_tpu.models import quant as jquant
    j8 = jax.tree.map(np.asarray, jquant.quantize_llm(jl, bits=8))
    t8 = from_jax_params(j8, tc, device="cpu")
    want = _flat(jlora.merge_lora(j8))
    got = dict(ttrain.tree_leaves(tlora.merge_lora(t8)))
    assert got["llm/layers/q_w"].dtype == torch.int8
    for p in ("llm/layers/q_w", "llm/layers/q_w_scale",
              "llm/layers/down_w", "llm/layers/down_w_scale"):
        np.testing.assert_array_equal(got[p].numpy(), want[p], err_msg=p)


_JAX_GRADS = {}


def _jax_loss_and_grads(stack, lora_only):
    """(params, batch, loss, {path: grad}) of the JAX reference, computed
    once per lora_only for the parametrisations that share it."""
    if lora_only in _JAX_GRADS:
        return _JAX_GRADS[lora_only]
    jc, _, jp = stack
    if lora_only:
        jp = jlora.add_lora(jp, jax.random.PRNGKey(3), jc.llm, rank=4)
        rng = np.random.default_rng(4)
        jp = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                                     x.dtype)
            if "_lora_b" in jmesh._path_str(p) else x, jp)
    batch = _batch(jc, 5)
    jlayout = {k: jnp.asarray(batch[k]) for k in _t_layout(batch)}

    def jloss(p):
        return jsv.forward_train(p, jc, jnp.asarray(batch["images"]),
                                 jlayout, attn_impl="dense")[0]

    if lora_only:
        ad = {p: x for p, x in _flat(jp).items() if jlora.is_lora_path(p)}

        def jloss_lora(ad):
            return jloss(jax.tree_util.tree_map_with_path(
                lambda p, x: ad.get(jmesh._path_str(p), x), jp))
        loss, grads = jax.value_and_grad(jloss_lora)(
            jax.tree.map(jnp.asarray, ad))
    else:
        loss, grads = jax.value_and_grad(jloss)(jp)
        grads = _flat(grads)
    _JAX_GRADS[lora_only] = (jp, batch, float(loss), grads)
    return _JAX_GRADS[lora_only]


@pytest.mark.parametrize("lora_only", [False, True])
@pytest.mark.parametrize("chunk,remat,remat_chunk,mlp_chunk", [
    (None, False, None, None), (64, True, None, None),
    (32, True, 2, 64)])
def test_forward_train_loss_and_grads_match_jax(stack, lora_only, chunk,
                                                remat, remat_chunk,
                                                mlp_chunk):
    """Loss and the gradient of every trainable leaf against
    jax.value_and_grad (JAX: dense attention, full logits, no remat).
    lora_only differentiates only the adapters (B made nonzero so A gets
    a gradient); full SFT differentiates every leaf."""
    _, tc, _ = stack
    jp, batch, want_loss, jgrads = _jax_loss_and_grads(stack, lora_only)
    tp = from_jax_params(_np(jp), tc, device="cpu")
    leaves = dict(ttrain.tree_leaves(tp))
    names = sorted(jgrads)
    for p, t in leaves.items():
        t.requires_grad_(p in jgrads)
    n3 = fa.lse_launches
    loss, logits = tsv.forward_train(
        tp, tc, torch.from_numpy(batch["images"]), _t_layout(batch),
        remat=remat, loss_chunk_size=chunk, remat_chunk=remat_chunk,
        mlp_chunk=mlp_chunk)
    assert (logits is None) == (chunk is not None)
    got = torch.autograd.grad(loss, [leaves[p] for p in names],
                              allow_unused=True)
    assert fa.lse_launches == n3            # CPU: plain versions only
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for p, g in zip(names, got):
        want = np.asarray(jgrads[p])
        g = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=RTOL,
                                   err_msg=p)
        if lora_only and "_lora_" in p:
            assert np.abs(g).max() > 0, p


@pytest.mark.parametrize("lora_only", [False, True])
def test_train_step_trajectory_matches_jax(stack, lora_only):
    """Three optimizer steps of grad_accum 2 (six micro-steps over two
    batches): per-group clipping, the warmup-cosine schedule (lr 0 on the
    first update), AdamW and MultiSteps, with freeze_vision and a separate
    projector lr (full SFT) or lora_only; every param after every
    micro-step, and loss/grad_norm, against JAX on a one-device mesh."""
    jc, tc, jp = stack
    if lora_only:
        jp = jlora.add_lora(jp, jax.random.PRNGKey(6), jc.llm, rank=4)
    kw = dict(learning_rate=1e-3, projector_lr=3e-4, total_steps=6,
              warmup_ratio=0.2, grad_accum_steps=2, grad_clip=0.5,
              weight_decay=0.01, loss_chunk_size=64)
    kw.update(lora_only=True) if lora_only else kw.update(freeze_vision=True)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    batches = [_batch(jc, 7), _batch(jc, 8)]

    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, jp), jt)
    jstep = jtrain.make_train_step(jc, jt, mesh)
    tstate = ttrain.create_train_state(
        from_jax_params(_np(jp), tc, device="cpu"), tt)
    tstep = ttrain.make_train_step(tc, tt, device="cpu")
    start = {p: t.detach().clone() for p, t in
             ttrain.tree_leaves(tstate.params)}
    for i in range(6):
        b = batches[i % 2]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    b.items()})
        tstate, tm = tstep(tstate, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=RTOL)
        want = _flat(jstate.params)
        for p, t in ttrain.tree_leaves(tstate.params):
            np.testing.assert_allclose(t.detach().numpy(), want[p],
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"micro-step {i} {p}")
    assert tstate.step == 6
    moved = {p for p, t in ttrain.tree_leaves(tstate.params)
             if not torch.equal(t, start[p])}
    if lora_only:
        assert moved and all(tlora.is_lora_path(p) for p in moved)
    else:
        assert moved and not any(p.startswith("vision/") for p in moved)


def test_schedule_is_optax_warmup_cosine():
    import optax
    t = ttrain.TrainConfig(total_steps=50, warmup_ratio=0.1)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 50)
    for c in (0, 1, 4, 5, 6, 30, 49, 50, 60):
        np.testing.assert_allclose(ttrain.schedule(t, 3e-4, c),
                                   float(want(c)), rtol=2e-5, atol=1e-12)


@pytest.fixture(scope="module")
def traj_root(tmp_path_factory):
    """Two episodes written with the port's write_trajectory: 12 actions
    (two windows at num_frames 8) and 5 actions."""
    root = str(tmp_path_factory.mktemp("traj"))
    rng = np.random.default_rng(9)
    entries = [tvln.write_trajectory(
        root, f"ep{ep}", rng.integers(0, 256, (n, 48, 64, 3), np.uint8),
        [f"go to room {ep}", f"find door {ep}"],
        rng.integers(0, 4, n).tolist()) for ep, n in ((0, 12), (1, 5))]
    tvln.write_annotations(root, entries)
    return root


def test_vln_dataset_and_collate_match_jax(traj_root):
    """Samples (ids, labels, images, time_ids) and collated batches equal
    the JAX package's on the same trajectory tree. Both read the JPEGs
    with PIL (an identity transform keeps the JAX side off its C++
    loader)."""
    cfg, jc = tcfg.tiny_streamvln(), jcfg.tiny_streamvln()
    ident = (lambda img: img)  # noqa: E731
    tds = tvln.VLNActionDataset(ByteTokenizer(), cfg, [traj_root],
                                transform=ident, image_size=56, seed=3)
    jds = jvln.VLNActionDataset(JByteTokenizer(), jc, [traj_root],
                                transform=ident, image_size=56, seed=3)
    assert tds.data_list == jds.data_list and len(tds) == 6
    samples = []
    for i in range(len(tds)):
        t, j = tds[i], jds[i]
        for k in ("input_ids", "labels", "time_ids"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        np.testing.assert_allclose(t["images"], j["images"], atol=1e-6)
        assert t["task_id"] == j["task_id"]
        samples.append((t, j))
    # the second window of episode 0 carries <memory> and history frames
    assert (samples[1][0]["input_ids"] == -300).sum() == 1
    for group in ([0, 1], [1, 2, 4]):
        tb = tcollate.collate([samples[i][0] for i in group], cfg)
        jb = jcollate.collate([samples[i][1] for i in group], jc)
        assert set(tb) == set(jb)
        for k in jb:
            np.testing.assert_allclose(tb[k], jb[k], atol=1e-6, err_msg=k)
    # frames preprocessed elsewhere (tensors, as on the card) collate the
    # same way
    ts = [dict(s, images=torch.from_numpy(s["images"]))
          for s, _ in samples[:2]]
    tb = tcollate.collate(ts, cfg)
    np.testing.assert_allclose(tb["images"].numpy(),
                               jcollate.collate([s for _, s in samples[:2]],
                                                jc)["images"], atol=1e-6)
    assert tcollate.pick_bucket(600, tcollate.DEFAULT_LENGTH_BUCKETS) == \
        jcollate.pick_bucket(600, jcollate.DEFAULT_LENGTH_BUCKETS) == 1024


def test_samplers_and_wrappers_match_jax():
    lengths = np.random.default_rng(0).integers(10, 500, 57)
    tasks = np.arange(57) % 3
    assert list(tcollate.LengthGroupedBatchSampler(lengths, 4, seed=1)) == \
        list(jcollate.LengthGroupedBatchSampler(lengths, 4, seed=1))
    for drop in (True, False):
        t = tcollate.TaskGroupedBatchSampler(tasks, 5, seed=2,
                                             drop_last=drop)
        j = jcollate.TaskGroupedBatchSampler(tasks, 5, seed=2,
                                             drop_last=drop)
        assert list(t) == list(j) and len(t) == len(j)

    class Flaky:
        task_id = 1

        def __init__(self, n):
            self.n, self.calls = n, 0

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            self.calls += 1
            if i == 2:
                raise OSError("corrupt frame")
            return i

    for mod in (tcollate, jcollate):
        ds = mod.RobustDataset(Flaky(5))
        assert ds[2] == 3 and ds.task_id == 1
        comb = mod.CombineDataset([Flaky(3), Flaky(4)])
        assert len(comb) == 7 and comb[4] == 1
        assert list(comb.task_ids) == [1] * 7
