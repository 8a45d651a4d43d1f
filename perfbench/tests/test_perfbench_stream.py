import numpy as np

from perfbench.harness import load_json, BENCH
from perfbench.stream import WARMUP, DocStream, Pool, _quantiles


def traffic(name):
    return load_json(BENCH / "traffic" / f"{name}.json")


def test_same_seed_same_documents():
    t = traffic("mpdocvqa")
    a, b = DocStream(t, 2**31 + 5).take(20), DocStream(t, 2**31 + 5).take(20)
    assert [(d.question, d.words, d.answers, d.answer_page_idx) for d in a] == \
           [(d.question, d.words, d.answers, d.answer_page_idx) for d in b]
    assert all(np.array_equal(x, y) for da, db in zip(a, b) for x, y in zip(da.boxes, db.boxes))


def test_seeds_share_sizes_not_words():
    t = traffic("mpdocvqa")
    n = t["block_docs"]
    a, b = DocStream(t, 1).take(n), DocStream(t, 2).take(n)
    sizes = lambda docs: sorted(len(p) for d in docs for p in d.words)
    assert sizes(a) == sizes(b)
    assert sorted(len(d.words) for d in a) == sorted(len(d.words) for d in b)
    assert [d.words for d in a] != [d.words for d in b]


def test_streams_and_extension_never_repeat():
    t = dict(traffic("demo"), pool_docs=8)
    pool = Pool(t, 9)
    first = pool[0:8] + pool[8:16]
    assert pool.extended == 8
    warm = DocStream(t, 9, WARMUP).take(16)
    texts = [tuple(map(tuple, d.words)) for d in first + warm]
    assert len(set(texts)) == len(texts)
    assert [d.question_id for d in first] == list(range(16))


def test_distributions_hold():
    for name, mean, lo, hi in (("mpdocvqa", 8, 1, 20), ("longdoc", 48, 10, 200)):
        t = traffic(name)
        pages = _quantiles(t["pages"], t["block_docs"])
        assert lo == pages.min() and pages.max() == hi
        assert abs(pages.mean() - mean) / mean < 0.05
        docs = DocStream(t, 3).take(t["block_docs"] if name == "mpdocvqa" else 4)
        w = t["words_per_page"]
        for d in docs:
            assert lo <= len(d.words) <= hi
            assert all(w["min"] <= len(p) <= w["max"] for p in d.words)
            q = d.question.split()
            assert 4 <= len(q) <= 12 and q[:3] == ["what", "is", "the"]
            page = d.words[d.answer_page_idx]
            k = page.index(q[3])
            assert page[k - 1:k + 3] == ["the", q[3], "is", d.answers[0]]


def test_zipf_vocabulary_repeats_like_text():
    t = traffic("mpdocvqa")
    words = [w for d in DocStream(t, 4).take(32) for p in d.words for w in p]
    distinct = len(set(words)) / len(words)
    # a 33-word vocabulary makes this ~0; Zipf(1.1) over 50,000 forms leaves a
    # long tail of new words, as OCR text does
    assert 0.05 < distinct < 0.5
