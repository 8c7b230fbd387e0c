"""The yardstick's counts at one shape, worked out by hand, and the
tokenizer against the `tokenizers` library's reading of the same file."""
import pytest

from portbench.harness import flops, spec, trace

LC = {"vocab_size": 10, "hidden_size": 4, "intermediate_size": 6,
      "num_layers": 2, "num_heads": 2, "num_kv_heads": 1, "head_dim": 2}


def test_decoder_counts_by_hand():
    # one token through one layer: q 4x4, k 4x2, v 4x2, o 4x4, gate/up
    # 4x6 each, down 6x4: 16 + 8 + 8 + 16 + 72 = 120 products
    assert flops._llm_linear(LC) == 2 * 120
    # 3 queries at offset 5 see 6 + 7 + 8 keys: x layers x 4 x heads x dh
    assert flops._attention(LC, 5, 3) == 2 * 4 * 2 * 2 * 21
    assert flops.head(LC) == 2 * 4 * 10
    assert flops.prefill(LC, 5, 3) == 2 * 3 * 240 + 2 * 4 * 2 * 2 * 21 + 80
    assert flops.decode(LC, 8, 2) == 2 * (2 * 240 + 80) + \
        2 * 4 * 2 * 2 * (9 + 10)


def test_vision_counts_by_hand():
    cfg = {"vision": {"patch_size": 2, "hidden_size": 3,
                      "intermediate_size": 5, "num_layers": 1,
                      "image_size": 4},
           "llm": {"hidden_size": 7}}
    n = 4       # 2 x 2 patches
    layer = 2 * n * (4 * 9 + 2 * 15) + 4 * n * n * 3
    assert flops.vision_frame(cfg) == 2 * n * 12 * 3 + layer + \
        2 * n * (3 * 7 + 49)


def test_call_counts_prompt_and_fed_tokens():
    cfg = {"vision": {"patch_size": 2, "hidden_size": 3,
                      "intermediate_size": 5, "num_layers": 1,
                      "image_size": 4}, "llm": LC}
    rec = {"served": [1, 2, 3, 4], "kv_before": 5, "prefill_len": 3}
    assert flops.call(cfg, rec) == flops.vision_frame(cfg) + \
        flops.prefill(LC, 5, 3) + flops.decode(LC, 8, 3)


def test_int4_bytes_by_hand():
    assert flops.int4_bytes(128, 8, 64) == 128 * 8 // 2 + 2 * 8 * 4
    lc = dict(LC, hidden_size=128, intermediate_size=64, num_heads=1,
              num_kv_heads=1, head_dim=128, num_layers=1, vocab_size=512)
    products = [(128, 384), (128, 128), (128, 128), (64, 128)]
    layer = sum(i * o // 2 + (i // 64) * o * 4 + 2 * i + 4 * o
                for i, o in products)
    head = 128 * 512 // 2 + 2 * 512 * 4 + 2 * 128 + 4 * 512
    assert flops.int4_decode_pass_bytes(lc, 64) == layer + head


def test_union_of_intervals():
    busy, blocks = trace.union_s([(0, 10), (5, 20), (30, 40), (50, 70)],
                                 2, 60)
    assert blocks == [(2, 20), (30, 40), (50, 60)]
    assert busy == pytest.approx(38e-6)


def test_bpe_reader_matches_the_file():
    tokenizers = pytest.importorskip("tokenizers")
    from portbench.reference.bpe import DEFAULT_PATH, Tokenizer
    ours = Tokenizer()
    lib = tokenizers.Tokenizer.from_file(DEFAULT_PATH)
    lib.add_special_tokens(["<image>", "<memory>"])
    texts = [
        "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n",
        "Walk past the kitchen_table, turn left (←) at 3 doors.\n\nStop.",
        "a_b!!  's 'll x'd \t end  ", "MOVE FORWARD (↑) by 25 cm, STOP.",
        "you can see <image>. You have visited these areas <memory>.",
        "ümlaut naïve café 123456 日本",
    ]
    from portbench.harness.traffic import instruction
    import numpy as np
    rng = np.random.default_rng(3)
    texts += [instruction(rng, n) for n in (18, 29, 40)]
    for text in texts:
        ids = ours.encode(text)
        assert ids == lib.encode(text, add_special_tokens=False).ids
        assert ours.decode(ids) == text
    assert (ours.image_token_id, ours.memory_token_id) == (
        lib.token_to_id("<image>"), lib.token_to_id("<memory>"))


def test_prompts_stay_in_their_buckets():
    """At the robot mix's longest instructions (100 drawn), the <memory>
    call stays in the 2,048 bucket, a first call in the 512 one, and the
    window inside the 4,096 slots."""
    import numpy as np
    from portbench.reference import bpe, dialogue
    from portbench.harness import traffic
    tok = bpe.Tokenizer()
    mix = spec.mix("robot")
    n = mix["instruction_words"]["max"]
    for seed in range(100):
        text = traffic.instruction(np.random.default_rng(seed), n)
        for t0, bucket in ((32, 2048), (0, 512)):
            calls = [dialogue.Call(t0 + 4 * j, 0, [7] * 16)
                     for j in range(8)]
            _, targets = dialogue.sequence(
                tok, dialogue.Window(text, calls, [0] * 64), 8, 196)
            assert targets[0][0] + 1 <= bucket
            assert targets[-1][0] + 1 + 24 <= 4096
