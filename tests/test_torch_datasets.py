"""Port parity, the dataset loaders (`rag_docvqa_tpu_torch/data/datasets.py`,
`data/pdf.py`): the fifteen cases of `tests/test_datasets.py` on the same
fixture files under `tmp_path`, each run through the JAX loader and the
port's; the documents must be equal field by field (words, boxes, answers,
page indices, ids, answer types, page images as arrays, layouts, extras).
Then what the port does differently on purpose: a missing Pillow, pdfminer,
pdf2image or `datasets` raises an ImportError that names it (the JAX loader
leaves every page without an image when Pillow is missing), while a missing
or unreadable image file still gives that page None in both. Everything is
host work on strings and numpy: equal exactly."""

import dataclasses
import json
import random
import sys

import numpy as np
import pytest

from rag_docvqa_tpu.data import datasets as j_ds
from rag_docvqa_tpu.data.contract import RawDocument as JRawDocument
from rag_docvqa_tpu_torch.data import datasets as p_ds
from rag_docvqa_tpu_torch.data.contract import RawDocument as PRawDocument


def _same(a, b, where="doc"):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert type(b) is dict and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def same_docs(got, want):
    """Port documents against JAX ones, field by field."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, PRawDocument) and isinstance(w, JRawDocument)
        names = [f.name for f in dataclasses.fields(w)]
        assert [f.name for f in dataclasses.fields(g)] == names
        for n in names:
            _same(getattr(g, n), getattr(w, n), f"doc {i}.{n}")


def _write_image(path, seed, size=(24, 32)):
    """A seeded RGB page written losslessly (PNG bytes, whatever the name)."""
    from PIL import Image

    img = np.random.RandomState(seed).randint(0, 256, (*size, 3)).astype(np.uint8)
    Image.fromarray(img).save(path, format="PNG")
    return img


@pytest.fixture()
def imdb_dir(tmp_path):
    """The MP-DocVQA imdb of `tests/test_datasets.py` (header + 3 records of
    2-3 pages), plus seeded page images under images/ (record 2's last page
    has no file and record 1's second page a file that is no image) and a
    precomputed-layouts .npz keyed by image name."""
    records = [{"dataset_version": "test"}]
    images = tmp_path / "images"
    images.mkdir()
    layouts = {}
    for i in range(3):
        n_pages = 2 + i % 2
        records.append(
            {
                "question_id": 100 + i,
                "question": f"what is item {i}?",
                "answers": [f"Answer{i}", f"answer{i}"],
                "answer_page_idx": i % n_pages,
                "imdb_doc_pages": n_pages,
                "image_id": f"doc{i}",
                "image_name": [f"doc{i}_p{p}" for p in range(n_pages)],
                "ocr_tokens": [[f"Word{p}{j}" for j in range(6)] for p in range(n_pages)],
                "ocr_normalized_boxes": [
                    np.asarray([[j / 10, 0.1, j / 10 + 0.05, 0.2] for j in range(6)], np.float32)
                    for p in range(n_pages)
                ],
            }
        )
        for p in range(n_pages):
            name = f"doc{i}_p{p}"
            layouts[name] = {"boxes": [[0.0, 0.0, 0.5, 0.5 + p / 10]], "labels": [1 + i]}
            if (i, p) == (2, n_pages - 1):
                continue
            if (i, p) == (1, 1):
                (images / f"{name}.jpg").write_bytes(b"not an image")
                continue
            _write_image(images / f"{name}.jpg", seed=10 * i + p)
    np.save(tmp_path / "imdb_val.npy", np.asarray(records, dtype=object), allow_pickle=True)
    np.savez(tmp_path / "layouts.npz", **{k: np.asarray(v, dtype=object) for k, v in layouts.items()})
    return str(tmp_path)


def both(fn):
    """fn(module) through the JAX loaders and the port's: (port, JAX)."""
    return fn(p_ds), fn(j_ds)


def all_docs(ds):
    return [ds[i] for i in range(len(ds))]


def test_mpdocvqa_concat_view(imdb_dir):
    got, want = both(lambda m: all_docs(m.MPDocVQADataset(imdb_dir, split="val", page_retrieval="concat")))
    same_docs(got, want)
    assert len(got) == 3 and len(got[0].words) == 2 and got[0].words[0][0] == "word00" and got[0].question_id == 100


def test_mpdocvqa_oracle_view(imdb_dir):
    got, want = both(lambda m: all_docs(m.MPDocVQADataset(imdb_dir, split="val", page_retrieval="oracle")))
    same_docs(got, want)
    assert len(got[1].words) == 1 and got[1].answer_page_idx == 0 and got[1].words[0][0] == "word10"


def test_mpdocvqa_custom_window(imdb_dir):
    """The same seeded windows: every record twice, so the generator's state
    moves on between calls in both."""
    got, want = both(lambda m: [m.MPDocVQADataset(imdb_dir, split="val", page_retrieval="custom", max_pages=2,
                                                  seed=s)[i] for s in (0, 42) for i in (0, 1, 2, 1, 2)])
    same_docs(got, want)
    assert all(len(d.words) <= 2 and 0 <= d.answer_page_idx < len(d.words) for d in got)


def test_mpdocvqa_sample_lookup(imdb_dir):
    got, want = both(lambda m: m.MPDocVQADataset(imdb_dir, split="val").sample(101))
    same_docs([got], [want])
    for m in (p_ds, j_ds):
        with pytest.raises(ValueError):
            m.MPDocVQADataset(imdb_dir, split="val").sample(999)


def test_spdocvqa(tmp_path):
    records = [
        {"dataset_version": "t"},
        {
            "question_id": 7,
            "question": "q?",
            "answers": ["A"],
            "image_name": "img0",
            "ocr_tokens": ["Hello", "World"],
            "ocr_normalized_boxes": np.asarray([[0, 0, 0.1, 0.1], [0.2, 0, 0.3, 0.1]], np.float32),
        },
    ]
    np.save(tmp_path / "imdb_val.npy", np.asarray(records, dtype=object), allow_pickle=True)
    _write_image(tmp_path / "img0.png", seed=3)
    for kw in ({}, {"images_dir": str(tmp_path), "use_images": True}):
        got, want = both(lambda m: all_docs(m.SPDocVQADataset(str(tmp_path), split="val", **kw)))
        same_docs(got, want)
        assert got[0].words == [["hello", "world"]] and got[0].answer_page_idx == 0
    assert got[0].images[0].shape == (24, 32, 3)


def test_infographics(tmp_path):
    qas = {"data": [{"questionId": 5, "question": "total?", "answers": ["42 dollars"], "image_local_name": "info1.jpeg"},
                    {"questionId": 6, "question": "year?", "answers": ["2020"], "image_local_name": "info2.jpeg"}]}
    (tmp_path / "qas.json").write_text(json.dumps(qas))
    ocr = {"WORD": [{"BlockType": "WORD", "Text": "Total",
                     "Geometry": {"Polygon": [{"X": 0.1, "Y": 0.2}, {"X": 0.3, "Y": 0.2}, {"X": 0.3, "Y": 0.25},
                                              {"X": 0.1, "Y": 0.25}]}}]}
    (tmp_path / "info1.json").write_text(json.dumps(ocr))
    # the Blocks form with a bounding box and a LINE block that is skipped
    ocr2 = {"Blocks": [{"BlockType": "LINE", "Text": "The Year"},
                       {"BlockType": "WORD", "Text": "Year",
                        "Geometry": {"BoundingBox": {"Left": 0.5, "Top": 0.1, "Width": 0.2, "Height": 0.05}}}]}
    (tmp_path / "info2.json").write_text(json.dumps(ocr2))
    _write_image(tmp_path / "info1.jpeg", seed=4)
    for kw in ({}, {"images_dir": str(tmp_path), "use_images": True}):
        got, want = both(lambda m: all_docs(m.InfographicsDataset(str(tmp_path / "qas.json"), str(tmp_path), **kw)))
        same_docs(got, want)
    assert got[0].words == [["total"]] and got[0].boxes[0][0] == [0.1, 0.2, 0.3, 0.25]
    assert got[0].images[0].shape == (24, 32, 3) and got[1].images == [None]  # no info2.jpeg


def test_rotate_landscape_box():
    for box in ([0.1, 0.2, 0.4, 0.6], [0.0, 0.0, 1.0, 1.0]):
        assert p_ds.rotate_landscape_box(box) == j_ds.rotate_landscape_box(box)


def _noise_doc(cls):
    return cls(question="q", words=[["a"], ["b"], ["answer"]], boxes=[[[0, 0, 1, 1]]] * 3, answers=["answer"],
               answer_page_idx=2)


def test_noise_injection_preserves_answer_page():
    noise = [(["n1"], [[0, 0, 1, 1]]), (["n2"], [[0, 0, 1, 1]])]
    for mix in (True, False):
        got, want = [], []
        for m, cls, out in ((p_ds, PRawDocument, got), (j_ds, JRawDocument, want)):
            rng = random.Random(0)
            out += [m.inject_noise_pages(_noise_doc(cls), noise, mix=mix, rng=rng) for _ in range(10)]
        same_docs(got, want)
        assert all(d.words[d.answer_page_idx] == ["answer"] and len(d.words) == 5 for d in got)


def test_noise_wrapper(imdb_dir):
    def run(m):
        base = m.MPDocVQADataset(imdb_dir, split="val", page_retrieval="concat")
        ds = m.NoisePagesWrapper(base, noise_pages=2, mix=True, seed=0)
        return all_docs(ds) + [m.NoisePagesWrapper(base, noise_pages=0)[1],
                               m.NoisePagesWrapper(base, noise_pages=3, mix=False, seed=5)[2]]

    got, want = both(run)
    same_docs(got, want)
    assert len(got[0].words) == 4 and got[0].words[got[0].answer_page_idx] == ["word00", "word01", "word02", "word03",
                                                                                "word04", "word05"]


def test_build_dataset_registry(imdb_dir, tmp_path):
    configs = [{"dataset_name": "MP-DocVQA", "imdb_dir": imdb_dir},
               {"dataset_name": "MP-DocVQA-Noise", "imdb_dir": imdb_dir, "noise_pages": 1},
               {"dataset_name": "MP-DocVQA", "imdb_dir": imdb_dir, "images_dir": f"{imdb_dir}/images",
                "use_images": True, "page_retrieval": "custom", "max_pages": 2, "use_precomputed_layouts": True,
                "precomputed_layouts_path": f"{imdb_dir}/layouts.npz"},
               {"dataset_name": "SP-DocVQA", "imdb_dir": imdb_dir}]
    for c in configs[:3]:
        got, want = both(lambda m: all_docs(m.build_dataset(c, "val")))
        same_docs(got, want)
    assert len(got) == 3 and got[0].layout is not None and any(im is not None for im in got[0].images)
    for m in (p_ds, j_ds):
        with pytest.raises(ValueError):
            m.build_dataset({"dataset_name": "Unknown"}, "val")
        with pytest.raises(SystemExit):
            m.build_dataset({}, "val")


def test_proportional_sampling():
    recs = [{"id": i, "pages": 1 + (i % 3)} for i in range(30)]
    skew = [{"id": i, "pages": 1 if i < 25 else 2 + i % 2} for i in range(30)]
    for r, n in ((recs, 9), (recs, 10), (skew, 12), (skew, 30)):
        got, want = both(lambda m: m.proportional_sampling_by_pages(r, n, lambda x: x["pages"], seed=3))
        assert got == want and len(got) == n


def test_balanced_nac():
    def docs(cls):
        return [cls(question=f"q{i}", words=[[]], boxes=[[]], answer_type="not-answerable") for i in range(2)] + \
               [cls(question=f"a{i}", words=[[]], boxes=[[]], answer_type="string") for i in range(10)]

    got, want = p_ds.create_balanced_nac_dataset(docs(PRawDocument)), j_ds.create_balanced_nac_dataset(docs(JRawDocument))
    same_docs(got, want)
    assert [d.answer_type for d in got].count("string") == 2


def test_dude_raw_build_pipeline(tmp_path):
    """Raw DUDE documents -> per-question records -> save_to_disk ->
    DUDEDataset, in both packages from the same raw directory; the records,
    the documents and their ingested arrays equal."""
    import datasets as hf_datasets

    from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
    from rag_docvqa_tpu.data import HashTokenizer as JHash
    from rag_docvqa_tpu.data.contract import Caps as JCaps
    from rag_docvqa_tpu.ops.chunking import ChunkSpec as JSpec
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    def make_doc(n_pages, qid0):
        return {
            "questions": [{"question": f"q{qid0 + i}?", "answers": [f"A{qid0 + i}"],
                           "answer_type": "not-answerable" if i == 1 else "string", "question_id": qid0 + i}
                          for i in range(2)],
            "ocr_tokens": [[f"w{p}_{j}" for j in range(6)] for p in range(n_pages)],
            "ocr_boxes": [[[0.1, 0.1, 0.2, 0.2]] * 6 for _ in range(n_pages)],
        }

    got, want = both(lambda m: m.format_dude_document(make_doc(5, 0), split="train", max_pages=2,
                                                      rng=random.Random(3)))
    _same(got, want, "records")
    assert all(len(r["ocr_tokens"]) == 2 and 0 <= r["answer_page_idx"] < 2 for r in got)
    # encoded page images are decoded and shrunk to 1024 px on the long side
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(1).randint(0, 256, (40, 2048, 3)).astype(np.uint8)).save(buf, "PNG")
    doc = dict(make_doc(2, 20), images=[buf.getvalue(), np.zeros((8, 8, 3), np.uint8)])
    got, want = both(lambda m: m.format_dude_document(doc, split="val", rng=random.Random(0)))
    _same(got, want, "records with images")
    assert got[0]["images"][0].shape == (20, 1024, 3)

    raw = hf_datasets.Dataset.from_dict({k: [make_doc(5, 0)[k], make_doc(2, 10)[k]]
                                         for k in ("questions", "ocr_tokens", "ocr_boxes")})
    raw.save_to_disk(str(tmp_path / "raw"))
    out_p = p_ds.build_dude(str(tmp_path / "raw"), str(tmp_path / "pre_port"), split="val", seed=0)
    out_j = j_ds.build_dude(str(tmp_path / "raw"), str(tmp_path / "pre_jax"), split="val", seed=0)
    for view in ("concat", "oracle"):
        got, want = all_docs(p_ds.DUDEDataset(out_p, split="val", page_retrieval=view)), \
            all_docs(j_ds.DUDEDataset(out_j, split="val", page_retrieval=view))
        same_docs(got, want)
    # the port reads the JAX package's cache and the other way round
    same_docs(all_docs(p_ds.DUDEDataset(out_j, split="val")), all_docs(j_ds.DUDEDataset(out_p, split="val")))
    got, want = all_docs(p_ds.DUDEDataset(out_p, split="val")), all_docs(j_ds.DUDEDataset(out_j, split="val"))
    assert len(got) == 4 and got[0].question == "q0?" and got[1].answer_type == "not-answerable"
    pb, _ = DocVQAIngestor(HashTokenizer(512), ChunkSpec(chunk_size=6, overlap=1),
                           Caps(max_pages=5, max_chunks=16, max_slots=128)).ingest(got)
    jb, _ = JIngestor(JHash(512), JSpec(chunk_size=6, overlap=1), JCaps(max_pages=5, max_chunks=16,
                                                                        max_slots=128)).ingest(want)
    for f in dataclasses.fields(jb):
        np.testing.assert_array_equal(np.asarray(getattr(pb, f.name)), np.asarray(getattr(jb, f.name)), f.name)


def test_hash_tokenizer_vocab_roundtrip(tmp_path):
    """save_vocab/load_vocab carry the reverse map across a process boundary,
    and the two packages read each other's file."""
    from rag_docvqa_tpu.data import HashTokenizer as JHash
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer

    text = "answers survive checkpoint restore"
    for saver, loader in ((HashTokenizer, JHash), (JHash, HashTokenizer), (HashTokenizer, HashTokenizer)):
        tok = saver(vocab_size=2048)
        ids = tok.encode(text)
        path = tmp_path / f"{saver.__module__}_{loader.__module__}.json"
        tok.save_vocab(str(path))
        fresh = loader(vocab_size=2048)
        assert fresh.encode(text) == ids and loader(vocab_size=2048).decode(ids) == ""
        fresh = loader(vocab_size=2048)
        fresh.load_vocab(str(path))
        assert fresh.decode(ids) == text


def test_sample_lookup_indexed():
    """BaseDataset.sample is a dict lookup after one scan, in both."""
    def tiny(m, cls):
        class Tiny(m.BaseDataset):
            def __init__(self):
                self.gets = 0

            def __len__(self):
                return 5

            def __getitem__(self, i):
                self.gets += 1
                return cls(question=f"q{i}", words=[["w"]], boxes=[[[0, 0, 1, 1]]], question_id=100 + i)

        return Tiny()

    for m, cls in ((p_ds, PRawDocument), (j_ds, JRawDocument)):
        ds = tiny(m, cls)
        assert ds.sample(104).question == "q4"
        first_pass = ds.gets
        assert ds.sample(100).question == "q0" and ds.gets == first_pass + 1
        with pytest.raises(ValueError):
            ds.sample(999)


# --------------------------------------------------------------------------- #
# page images, layouts, MMLongBench-Doc's mapping, and the missing packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("view", ["concat", "oracle", "custom"])
def test_mpdocvqa_images_and_layouts(imdb_dir, view):
    """`use_images` reads every page's file (a missing or unreadable one is
    None in both) and the layouts come from the .npz by image name."""
    kw = dict(split="val", page_retrieval=view, max_pages=2, images_dir=f"{imdb_dir}/images", use_images=True,
              precomputed_layouts_path=f"{imdb_dir}/layouts.npz")
    got, want = both(lambda m: all_docs(m.MPDocVQADataset(imdb_dir, **kw)))
    same_docs(got, want)
    if view == "concat":
        assert got[1].images[1] is None and got[2].images[1] is None
        np.testing.assert_array_equal(got[0].images[1], np.random.RandomState(1).randint(0, 256, (24, 32, 3)))
        assert got[2].layout[1] == {"boxes": [[0.0, 0.0, 0.5, 0.6]], "labels": [3]}


def test_missing_pillow_raises_naming_it(imdb_dir, monkeypatch):
    """Without PIL the port raises where the JAX loader gives every page None."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    kw = dict(split="val", images_dir=f"{imdb_dir}/images", use_images=True)
    assert all(im is None for d in all_docs(j_ds.MPDocVQADataset(imdb_dir, **kw)) for im in d.images)
    with pytest.raises(ImportError, match="Pillow"):
        p_ds.MPDocVQADataset(imdb_dir, **kw)[0]
    with pytest.raises(ImportError, match="Pillow"):
        p_ds.format_dude_document({"questions": [{"question": "q"}], "ocr_tokens": [["w"]], "ocr_boxes": [[[0] * 4]],
                                   "images": [b"\x89PNG"]})
    # without use_images nothing needs PIL
    assert p_ds.MPDocVQADataset(imdb_dir, split="val")[0].images is None


def test_missing_datasets_package_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="`datasets`"):
        p_ds.DUDEDataset(str(tmp_path))
    with pytest.raises(ImportError, match="`datasets`"):
        p_ds.build_dude(str(tmp_path), str(tmp_path / "out"))


def test_missing_pdf_packages_raise_naming_them(tmp_path, monkeypatch):
    """`load_pdf` names pdfminer (absent from some machines) and, asked for
    renders, pdf2image; MMLongBench-Doc reaches the first."""
    from rag_docvqa_tpu_torch.data import pdf as p_pdf

    (tmp_path / "samples.json").write_text(json.dumps([{"doc_id": "a.pdf", "question": "q", "answer": "1"}]))
    (tmp_path / "a.pdf").write_bytes(b"%PDF-1.4\n%%EOF\n")
    monkeypatch.setitem(sys.modules, "pdfminer", None)
    for mod in [m for m in sys.modules if m.startswith("pdfminer.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError, match="pdfminer"):
        p_pdf.load_pdf(str(tmp_path / "a.pdf"))
    with pytest.raises(ImportError, match="pdfminer"):
        p_ds.MMLongBenchDocDataset(str(tmp_path / "samples.json"), str(tmp_path))[0]


def test_pdf_render_names_pdf2image(tmp_path, monkeypatch):
    """The renders need pdf2image: with the word extraction stood in (the
    same pdfminer classes, empty pages), a missing pdf2image raises naming it."""
    import types

    from rag_docvqa_tpu_torch.data import pdf as p_pdf

    class Layout(list):
        bbox = (0, 0, 100, 200)

    mods = {"pdfminer": types.ModuleType("pdfminer")}
    for name, attrs in (("converter", {"PDFPageAggregator": lambda *a, **k: types.SimpleNamespace(
                             get_result=lambda: Layout())}),
                        ("layout", {"LAParams": lambda: None, "LTChar": type("LTChar", (), {}),
                                    "LTTextBox": type("LTTextBox", (), {})}),
                        ("pdfinterp", {"PDFPageInterpreter": lambda *a: types.SimpleNamespace(
                            process_page=lambda p: None), "PDFResourceManager": lambda: None}),
                        ("pdfpage", {"PDFPage": types.SimpleNamespace(get_pages=lambda fp: [0, 1])})):
        mods[f"pdfminer.{name}"] = types.SimpleNamespace(**attrs)
    for k, v in mods.items():
        monkeypatch.setitem(sys.modules, k, v)
    monkeypatch.setitem(sys.modules, "pdf2image", None)
    (tmp_path / "a.pdf").write_bytes(b"%PDF-1.4\n%%EOF\n")
    assert p_pdf.load_pdf(str(tmp_path / "a.pdf"), render_images=False) == ([[], []], [[], []], None)
    with pytest.raises(ImportError, match="pdf2image"):
        p_pdf.load_pdf(str(tmp_path / "a.pdf"))


def test_mmlongbench_records_match_jax(tmp_path, monkeypatch):
    """MMLongBench-Doc's sample -> document mapping (answer formats, evidence
    pages, the page cap, the per-document cache) on the same words and boxes
    in both, with `load_pdf` stood in by one function that counts its calls."""
    from rag_docvqa_tpu.data import pdf as j_pdf
    from rag_docvqa_tpu_torch.data import pdf as p_pdf

    calls = []

    def fake_load_pdf(path, render_images=True, dpi=72):
        calls.append((path.rsplit("/", 1)[-1], render_images, dpi))
        n = 3 + len(path) % 2
        return ([[f"w{p}_{j}" for j in range(4)] for p in range(n)],
                [[[0.1 * j, 0.2, 0.1 * j + 0.05, 0.3] for j in range(4)] for _ in range(n)], None)

    monkeypatch.setattr(p_pdf, "load_pdf", fake_load_pdf)
    monkeypatch.setattr(j_pdf, "load_pdf", fake_load_pdf)
    samples = [{"doc_id": "a.pdf", "question": "how many?", "answer": 12, "answer_format": "Int",
                "evidence_pages": [2], "evidence_sources": ["Table"], "doc_type": "report"},
               {"doc_name": "bb.pdf", "question": "who?", "answer": "Not answerable", "answer_format": "None"},
               {"doc_id": "a.pdf", "question": "list?", "answer": "['x']", "answer_format": "List",
                "evidence_pages": []}]
    (tmp_path / "samples.json").write_text(json.dumps(samples))
    for cap in (None, 2):
        calls.clear()
        got, want = both(lambda m: all_docs(m.MMLongBenchDocDataset(str(tmp_path / "samples.json"), str(tmp_path),
                                                                    max_pages=cap)))
        same_docs(got, want)
        assert calls == [("a.pdf", False, 72), ("bb.pdf", False, 72)] * 2  # one load a document, in each package
    assert got[0].answer_type == "int" and got[0].answer_page_idx == 1 and got[1].answer_type == "not-answerable"
