"""The work arithmetic against counts made by hand at a tiny size."""

import pytest

from perfbench import work

C = {"d_model": 4, "num_heads": 2, "d_kv": 2, "d_ff": 8, "num_layers": 1}


def test_encoder_counts():
    w = work.encoder_work(C, [3, 2])
    # a layer: q, k, v, o are 4x4, wi 8x4, wo 4x8 -> 4*16 + 2*32 = 128 multiply-adds a token;
    # attention over the row's valid keys: 2 * n * n * inner multiply-adds
    want = 2 * (3 + 2) * 128 + 4 * (3 * 3 + 2 * 2) * 4
    assert w.flops == want
    assert w.bytes == 2 * (128 + 2 * 4) + 2 * 2 * 4 * 5


def test_decode_counts_only_running_rows():
    vocab = 10
    w = work.decode_work(C, vocab, [3, 1], [2, 1])
    cross = 4 * 4 * 4 * (3 + 1)  # k and v of every encoder position, once
    per_row = 2 * (6 * 16 + 2 * 32) + 2 * 4 * vocab
    step0 = 2 * per_row + 4 * 4 * (2 * 1 + 3 + 1)
    step1 = per_row + 4 * 4 * (1 * 2 + 3)  # the second row has stopped
    assert w.flops == cross + step0 + step1
    weights = (6 * 16 + 2 * 32 + 3 * 4) * 2 + vocab * 4 * 2
    init = 2 * (2 * 16 + 4 * 4 + 2 * 4 * 4)
    b0 = weights + 2 * 2 * 4 * (4 + 2 * 1) + 2 * vocab * 2
    b1 = weights + 2 * 2 * 4 * (3 + 1 * 2) + vocab * 2
    assert w.bytes == init + b0 + b1


def test_page_head_counts_real_pages():
    w = work.page_head_work(C, [2, 1], page_tokens=3, max_pages=4)
    assert w.flops == 2 * (2 + 1) * 3 * 4 * 4
    assert w.bytes == 2 * 4 * 4 * 3 * 4 + 2 * 4 * 3 * 3


def test_least_time_is_the_larger_bound():
    assert work.Work(989e12, 0).least_s == pytest.approx(1.0)
    assert work.Work(1.0, 3.35e12).least_s == pytest.approx(1.0)
