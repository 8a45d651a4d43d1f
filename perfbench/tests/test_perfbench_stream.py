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


def painted(name="mpdocvqa"):
    return dict(traffic(name), page_images={"width": 96, "height": 128})


def test_page_images_repeat_bit_for_bit():
    t = painted()
    a, b = DocStream(t, 2**31 + 7).take(4), DocStream(t, 2**31 + 7).take(4)
    for da, db in zip(DocStream(t, 2**31 + 7).with_images(a), DocStream(t, 2**31 + 7).with_images(b)):
        assert len(da.images) == len(da.words)
        assert all(x.dtype == np.uint8 and x.shape == (128, 96, 3) and np.array_equal(x, y)
                   for x, y in zip(da.images, db.images))
    # the warm-up stream of the same seed paints the same question id differently
    other = DocStream(t, 2**31 + 7, WARMUP)
    assert not np.array_equal(other.page_image(a[0], 0), DocStream(t, 2**31 + 7).page_image(a[0], 0))


def test_no_page_images_without_the_key():
    docs = DocStream(traffic("mpdocvqa"), 5).take(8)
    assert all(d.images is None for d in docs)


def test_nothing_is_painted_in_set_up(monkeypatch):
    def refuse(self, doc, p):
        raise AssertionError("a page image made while the pool is built")

    monkeypatch.setattr(DocStream, "page_image", refuse)
    pool = Pool(dict(painted("demo"), pool_docs=8), 9)
    assert all(d.images is None for d in pool[0:12])


def test_a_chunk_crop_holds_its_words():
    from rag_docvqa_tpu_torch.config import build_caps, build_chunk_spec, load_tokenizer
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.ops.patches import crop_box

    t = painted()
    stream = DocStream(t, 2**31 + 9)
    docs = stream.with_images(stream.take(4))
    c = {"chunk_size": 60, "overlap": 10}
    ingestor = DocVQAIngestor(load_tokenizer("hash:512"), build_chunk_spec(c), build_caps(c))
    ingestor.caps = ingestor.plan_caps(docs)
    batch, aux = ingestor.ingest(docs)
    crops = 0
    for b, d in enumerate(docs):
        for k in np.flatnonzero(batch.chunk_mask[b]):
            page = d.images[batch.chunk_page[b, k]]
            crop = crop_box(page, batch.chunk_box[b, k])
            assert crop.size and crop.min() < page.max() - 64  # a word's dark box on the light page
            crops += 1
    assert crops > len(docs)
