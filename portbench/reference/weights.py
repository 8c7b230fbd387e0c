"""The benchmark's weights, made from the seed on the device.

One `torch.Generator` on the device, seeded with the run's seed, draws
every leaf in a fixed order, each stack in one call and in the type it is
served in. The tree has the layout the program takes (per-layer stacks
[L, ...], matrices [in, out], SigLIP's patch rows channel-major), and the
reference reads the same tree: the harness hands it to the program, and
after the program is gone the reference draws it again from the seed.

Dense weights ~ N(0, 1 / fan_in), with a share of outliers: 0.5% of the
entries, drawn from the seed, are 10 times larger. Trained LLM weights
carry such a sparse heavy tail (SpQR, arXiv:2306.03078, isolates ~1% of
outlier weights), and it is what makes a weight quantizer's column or
group scales coarse; without it, Gaussian weights quantize to int8 with
less error than bf16 arithmetic adds. Norm scales are 1 + N(0, 0.1^2) and
biases N(0, 0.02^2) (q/k/v biases of the decoder N(0, 0.1^2)), so that a
path that skips a scale or a bias reads differently.
"""
from __future__ import annotations

import torch

OUTLIER_SHARE = 0.005
OUTLIER_SCALE = 10.0


def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The full tree ({"vision", "projector", "llm", "image_newline"}) of
    configuration `cfg` (a parsed `portbench/configs/<name>.json`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(std)

    def dense(shape, fan_in):
        w = normal(shape, fan_in ** -0.5)
        hot = torch.rand(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(hot.lt_(OUTLIER_SHARE).mul_(OUTLIER_SCALE - 1.0)
                      .add_(1.0))

    def scale(shape):
        return normal(shape, 0.1).add_(1.0)

    def bias(shape, std=0.02):
        return normal(shape, std)

    vc, lc = cfg["vision"], cfg["llm"]
    L, D, Fv, P = (vc["num_layers"], vc["hidden_size"],
                   vc["intermediate_size"], vc["patch_size"])
    side = vc["image_size"] // P
    vision = {
        "patch_w": dense((P * P * 3, D), P * P * 3),
        "patch_b": bias((D,)),
        "pos_embed": dense((side * side, D), D),
        "layers": {
            "ln1_s": scale((L, D)), "ln1_b": bias((L, D)),
            "q_w": dense((L, D, D), D), "q_b": bias((L, D)),
            "k_w": dense((L, D, D), D), "k_b": bias((L, D)),
            "v_w": dense((L, D, D), D), "v_b": bias((L, D)),
            "o_w": dense((L, D, D), D), "o_b": bias((L, D)),
            "ln2_s": scale((L, D)), "ln2_b": bias((L, D)),
            "fc1_w": dense((L, D, Fv), D), "fc1_b": bias((L, Fv)),
            "fc2_w": dense((L, Fv, D), Fv), "fc2_b": bias((L, D)),
        },
    }
    Dm = lc["hidden_size"]
    proj = [{"w": dense((D, Dm), D), "b": bias((Dm,))},
            {"w": dense((Dm, Dm), Dm), "b": bias((Dm,))}]
    Ll, F = lc["num_layers"], lc["intermediate_size"]
    Hq, Hkv, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    llm = {
        "embed": dense((lc["vocab_size"], Dm), Dm),
        "layers": {
            "ln1": scale((Ll, Dm)),
            "q_w": dense((Ll, Dm, Hq * Dh), Dm),
            "q_b": bias((Ll, Hq * Dh), 0.1),
            "k_w": dense((Ll, Dm, Hkv * Dh), Dm),
            "k_b": bias((Ll, Hkv * Dh), 0.1),
            "v_w": dense((Ll, Dm, Hkv * Dh), Dm),
            "v_b": bias((Ll, Hkv * Dh), 0.1),
            "o_w": dense((Ll, Hq * Dh, Dm), Hq * Dh),
            "ln2": scale((Ll, Dm)),
            "gate_w": dense((Ll, Dm, F), Dm),
            "up_w": dense((Ll, Dm, F), Dm),
            "down_w": dense((Ll, F, Dm), F),
        },
        "final_norm": scale((Dm,)),
        "lm_head": dense((Dm, lc["vocab_size"]), Dm),
    }
    return {"vision": vision, "projector": {"layers": proj}, "llm": llm,
            "image_newline": dense((Dm,), Dm)}
