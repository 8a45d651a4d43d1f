"""Dataset loaders from local files: MP-DocVQA, SP-DocVQA, Infographics,
DUDE and MMLongBench-Doc, the noise-page views and the samplers.

The port's own copy of `rag_docvqa_tpu/data/datasets.py` (numpy and plain
Python); every loader yields this package's `RawDocument`, field for field
what the JAX loaders give (`tests/test_torch_datasets.py`). The retrieval
views: oracle and anyconforacle keep the answer page alone (its index becomes
0), custom a random `max_pages` window that holds the answer page, every other
strategy all pages.

Optional packages are imported where they are used, and an ImportError names
the one that is missing: Pillow for page images (`use_images`, DUDE's encoded
pages), the Hugging Face `datasets` for DUDE's cache, pdfminer for
MMLongBench-Doc's PDFs (`data/pdf.py`). Unlike the JAX loader, a missing
Pillow raises instead of leaving every page without an image; a missing or
unreadable image file still gives that page None, as there. Layouts come from
`precomputed_layouts_path` .npz files keyed by image name.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rag_docvqa_tpu_torch.data.contract import RawDocument

ORACLE_MODES = ("oracle", "anyconforacle")
ALL_PAGE_MODES = (
    "concat", "logits", "maxconf", "anyconf", "maxconfpage", "anyconfpage",
    "majorpage", "weightmajorpage", "none",
)


def _pil_image():
    """PIL's Image module; names Pillow where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading page images (use_images) needs Pillow, the `PIL` package, which is not "
                          "installed") from e
    return Image


def _hf_datasets():
    """The Hugging Face `datasets` package; named where it is not installed."""
    try:
        import datasets as hf_datasets
    except ImportError as e:
        raise ImportError("DUDE's preprocessing cache needs the Hugging Face `datasets` package, which is not "
                          "installed") from e
    return hf_datasets


def _load_image(path: str) -> Optional[np.ndarray]:
    """The page image as (H, W, 3) uint8, or None where the file is missing
    or cannot be read as an image. Without Pillow it raises: a dataset with
    `use_images` would otherwise have no image on any page."""
    Image = _pil_image()
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    except OSError:  # a missing file, or one PIL cannot identify or decode
        return None


class BaseDataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> RawDocument:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RawDocument]:
        for i in range(len(self)):
            yield self[i]

    def sample(self, question_id: int) -> RawDocument:
        """Lookup by question id (MP_DocVQA.py:48-66). The qid->index map is
        built lazily on first use, so repeated lookups (the demo REPL) are
        O(1) instead of a full-dataset scan."""
        index = getattr(self, "_qid_index", None)
        if index is None:
            index = {}
            for i in range(len(self)):
                index.setdefault(self[i].question_id, i)
            self._qid_index = index
        if question_id not in index:
            raise ValueError(f"Question ID {question_id} not in dataset.")
        return self[index[question_id]]


# --------------------------------------------------------------------------- #
# MP-DocVQA (npy imdb)
# --------------------------------------------------------------------------- #
class MPDocVQADataset(BaseDataset):
    """npy imdb records: header row + records with question/answers/
    answer_page_idx/image_name/ocr_tokens/ocr_normalized_boxes/imdb_doc_pages
    (MP_DocVQA.py:11-44)."""

    def __init__(
        self,
        imdb_dir: str,
        images_dir: str = "",
        split: str = "val",
        page_retrieval: str = "concat",
        max_pages: int = 1,
        size: Any = 1.0,
        use_images: bool = False,
        precomputed_layouts_path: Optional[str] = None,
        seed: int = 42,
    ):
        data = np.load(os.path.join(imdb_dir, f"imdb_{split}.npy"), allow_pickle=True)
        self.header = data[0]
        self.imdb = list(data[1:])
        if isinstance(size, float) and size < 1.0:
            self.imdb = self.imdb[: int(size * len(self.imdb))]
        elif isinstance(size, (tuple, list)) and len(size) == 2:
            self.imdb = self.imdb[int(size[0] * len(self.imdb)) : int(size[1] * len(self.imdb))]
        self.images_dir = images_dir
        self.page_retrieval = page_retrieval.lower()
        self.max_pages = max_pages
        self.use_images = use_images
        self.rng = random.Random(seed)
        self.layout_info = (
            np.load(precomputed_layouts_path, allow_pickle=True) if precomputed_layouts_path else None
        )

    def __len__(self) -> int:
        return len(self.imdb)

    def _page(self, record: Dict, p: int) -> Tuple[List[str], List[List[float]], Optional[np.ndarray], Optional[Dict]]:
        words = [w.lower() for w in record["ocr_tokens"][p]]
        boxes = [list(map(float, b)) for b in record["ocr_normalized_boxes"][p]]
        image = None
        layout = None
        name = record["image_name"][p] if isinstance(record["image_name"], (list, np.ndarray)) else record["image_name"]
        if self.use_images and self.images_dir:
            image = _load_image(os.path.join(self.images_dir, f"{name}.jpg"))
        if self.layout_info is not None:
            layout = self.layout_info[name].item()
        return words, boxes, image, layout

    def window(self, record: Dict) -> Tuple[int, int]:
        """Random max_pages window containing the answer page
        (MP_DocVQA.py:195-220)."""
        answer_page = record.get("answer_page_idx", 0)
        n = record["imdb_doc_pages"]
        if n <= self.max_pages:
            return 0, n
        lo = max(0, answer_page - self.max_pages + 1)
        first = self.rng.randint(lo, answer_page)
        last = first + self.max_pages
        if last > n:
            last, first = n, n - self.max_pages
        return first, last

    def __getitem__(self, idx: int) -> RawDocument:
        record = self.imdb[idx]
        answers = list(set(a.lower() for a in record.get("answers", [""])))
        answer_page_idx = record.get("answer_page_idx", 0) or 0
        n = record["imdb_doc_pages"]

        if self.page_retrieval in ORACLE_MODES:
            page_range = [answer_page_idx]
            answer_page_idx = 0
        elif self.page_retrieval == "custom":
            first, last = self.window(record)
            page_range = list(range(first, last))
            answer_page_idx = answer_page_idx - first
        else:
            page_range = list(range(n))

        words, boxes, images, layouts = [], [], [], []
        for p in page_range:
            w, b, img, lay = self._page(record, p)
            words.append(w)
            boxes.append(b)
            images.append(img)
            layouts.append(lay)
        return RawDocument(
            question=record["question"],
            words=words,
            boxes=boxes,
            answers=answers,
            answer_page_idx=answer_page_idx,
            question_id=record["question_id"],
            images=images if self.use_images else None,
            layout=layouts if self.layout_info is not None else None,
        )


# --------------------------------------------------------------------------- #
# SP-DocVQA (single page, SP_DocVQA.py)
# --------------------------------------------------------------------------- #
class SPDocVQADataset(MPDocVQADataset):
    def __getitem__(self, idx: int) -> RawDocument:
        record = self.imdb[idx]
        words = [[w.lower() for w in record["ocr_tokens"]]]
        boxes = [[list(map(float, b)) for b in record["ocr_normalized_boxes"]]]
        images = None
        if self.use_images and self.images_dir:
            images = [_load_image(os.path.join(self.images_dir, f"{record['image_name']}.png"))]
        return RawDocument(
            question=record["question"],
            words=words,
            boxes=boxes,
            answers=list(set(a.lower() for a in record["answers"])),
            answer_page_idx=0,
            question_id=record["question_id"],
            images=images,
        )


# --------------------------------------------------------------------------- #
# Infographics (JSON QAs + AWS-Textract-style OCR, Infographics.py)
# --------------------------------------------------------------------------- #
class InfographicsDataset(BaseDataset):
    def __init__(
        self,
        qas_path: str,
        ocr_dir: str,
        images_dir: str = "",
        use_images: bool = False,
    ):
        with open(qas_path) as f:
            self.qas = json.load(f)["data"]
        self.ocr_dir = ocr_dir
        self.images_dir = images_dir
        self.use_images = use_images

    def __len__(self) -> int:
        return len(self.qas)

    def __getitem__(self, idx: int) -> RawDocument:
        qa = self.qas[idx]
        image_id = os.path.splitext(qa["image_local_name"])[0]
        words, boxes = self._load_ocr(image_id)
        images = None
        if self.use_images and self.images_dir:
            images = [_load_image(os.path.join(self.images_dir, qa["image_local_name"]))]
        return RawDocument(
            question=qa["question"],
            words=[words],
            boxes=[boxes],
            answers=[a.lower() for a in qa.get("answers", [])],
            answer_page_idx=0,
            question_id=qa["questionId"],
            images=images,
        )

    def _load_ocr(self, image_id: str) -> Tuple[List[str], List[List[float]]]:
        """Textract LINE/WORD blocks, polygon -> box (Infographics.py:89-104)."""
        with open(os.path.join(self.ocr_dir, f"{image_id}.json")) as f:
            ocr = json.load(f)
        words, boxes = [], []
        for block in ocr.get("WORD", ocr.get("Blocks", [])):
            if isinstance(block, dict) and block.get("BlockType", "WORD") == "WORD":
                words.append(block.get("Text", "").lower())
                geom = block.get("Geometry", {})
                poly = geom.get("Polygon")
                if poly:
                    xs = [p["X"] for p in poly]
                    ys = [p["Y"] for p in poly]
                    boxes.append([min(xs), min(ys), max(xs), max(ys)])
                else:
                    bb = geom.get("BoundingBox", {})
                    x, y = bb.get("Left", 0), bb.get("Top", 0)
                    boxes.append([x, y, x + bb.get("Width", 0), y + bb.get("Height", 0)])
        return words, boxes


# --------------------------------------------------------------------------- #
# DUDE (HF-datasets preprocessing cache, DUDE.py)
# --------------------------------------------------------------------------- #
def rotate_landscape_box(box: Sequence[float]) -> List[float]:
    """Landscape-page rotation box remap [1-ymax, xmin, 1-ymin, xmax]
    (DUDE.py:93-97)."""
    xmin, ymin, xmax, ymax = box
    return [1 - ymax, xmin, 1 - ymin, xmax]


class DUDEDataset(BaseDataset):
    """Loads the save_to_disk preprocessing cache (DUDE.py:193-213). Records
    carry answer_type incl. "not-answerable"; no GT answer page (random page
    recorded at build time, DUDE.py:155)."""

    def __init__(self, dataset_dir: str, split: str = "val", page_retrieval: str = "concat"):
        hf_datasets = _hf_datasets()
        ds = hf_datasets.load_from_disk(dataset_dir)
        self.ds = ds[split] if hasattr(ds, "keys") and split in ds else ds
        self.page_retrieval = page_retrieval.lower()

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> RawDocument:
        rec = self.ds[idx]
        words = [[w.lower() for w in page] for page in rec["ocr_tokens"]]
        boxes = [[list(map(float, b)) for b in page] for page in rec["ocr_normalized_boxes"]]
        answers = [a.lower() for a in rec.get("answers", [])] or [""]
        answer_type = rec.get("answer_type", "string")
        answer_page = rec.get("answer_page_idx", 0) or 0
        if self.page_retrieval in ORACLE_MODES:
            words, boxes = [words[answer_page]], [boxes[answer_page]]
            answer_page = 0
        return RawDocument(
            question=rec["question"],
            words=words,
            boxes=boxes,
            answers=answers,
            answer_page_idx=answer_page,
            question_id=rec.get("question_id", idx),
            answer_type=answer_type,
        )


def format_dude_document(
    sample: Dict[str, Any],
    split: str = "val",
    max_pages: Optional[int] = None,
    rng: Optional[random.Random] = None,
) -> List[Dict[str, Any]]:
    """Raw DUDE document -> per-question records (reference DUDE_Raw.format_data,
    src/DUDE.py:132-181): decode+resize page images to <=1024px on the long
    side, pick a random answer page (DUDE provides none, :155), window the
    pages to max_pages around it for train, carry answers/answer_type.

    `sample` fields: questions (list of {question, answers, answer_type,
    question_id}), images (list of encoded bytes or arrays, optional),
    ocr_tokens (n_pages, n_words), ocr_boxes (n_pages, n_words, 4).
    """
    rng = rng or random.Random(0)
    n_pages = len(sample["ocr_tokens"])
    cap = max_pages if (split == "train" and max_pages) else None

    images = None
    if sample.get("images"):
        images = []
        for img in sample["images"]:
            if isinstance(img, (bytes, bytearray)):
                import io

                img = _pil_image().open(io.BytesIO(img))
                scale = 1024 / max(img.size)  # DUDE.py:146-152
                if scale < 1:
                    img = img.resize((int(img.size[0] * scale), int(img.size[1] * scale)))
                img = np.asarray(img.convert("RGB"))
            images.append(np.asarray(img))

    records = []
    for q in sample["questions"]:
        answer_page = rng.randint(0, max(n_pages - 1, 0))
        if cap is None or n_pages <= cap:
            first, last = 0, n_pages
        else:
            # random window of `max_pages` containing the answer page
            # (DUDE.py:158-168)
            first = rng.randint(max(0, answer_page - cap + 1), answer_page)
            last = first + cap
            if last > n_pages:
                last = n_pages
                first = last - cap
        rec = {
            "question": q["question"],
            "question_id": q.get("question_id", 0),
            "answers": [a.lower() for a in q.get("answers", [])] or [""],
            "answer_type": q.get("answer_type", "string"),
            "answer_page_idx": answer_page - first,
            "ocr_tokens": sample["ocr_tokens"][first:last],
            "ocr_normalized_boxes": sample["ocr_boxes"][first:last],
        }
        if images is not None:
            rec["images"] = images[first:last]
        records.append(rec)
    return records


def build_dude(
    raw_dir: str,
    out_dir: str,
    split: str = "val",
    max_pages: Optional[int] = None,
    seed: int = 0,
) -> str:
    """Raw HF DUDE dataset -> per-question save_to_disk cache consumable by
    DUDEDataset (reference build_dude, src/DUDE.py:183-213 + build_dude.py).
    Returns the written path."""
    hf_datasets = _hf_datasets()
    rng = random.Random(seed)
    saved = any(
        os.path.exists(os.path.join(raw_dir, f)) for f in ("state.json", "dataset_dict.json")
    )
    raw = hf_datasets.load_from_disk(raw_dir) if saved else hf_datasets.load_dataset(raw_dir, split=split)
    if hasattr(raw, "keys") and split in raw:
        raw = raw[split]

    records: List[Dict[str, Any]] = []
    for sample in raw:
        records.extend(format_dude_document(sample, split=split, max_pages=max_pages, rng=rng))
    keys = sorted({k for r in records for k in r})  # union: docs may differ
    cols = {k: [r.get(k) for r in records] for k in keys} if records else {}
    ds = hf_datasets.Dataset.from_dict(cols)
    out_path = os.path.join(out_dir, f"DUDE_{split}")
    ds.save_to_disk(out_path)
    return out_path


def create_balanced_nac_dataset(docs: Sequence[RawDocument], seed: int = 42) -> List[RawDocument]:
    """Rebalance answerable vs not-answerable for NAC training
    (DUDE.py:229-266): keep all not-answerable, subsample answerable to match."""
    rng = random.Random(seed)
    na = [d for d in docs if d.answer_type == "not-answerable"]
    ans = [d for d in docs if d.answer_type != "not-answerable"]
    if len(ans) > len(na) and na:
        ans = rng.sample(ans, len(na))
    out = na + ans
    rng.shuffle(out)
    return out


# --------------------------------------------------------------------------- #
# MMLongBenchDoc (samples.json + PDFs, MMLongBenchDoc.py)
# --------------------------------------------------------------------------- #
class MMLongBenchDocDataset(BaseDataset):
    def __init__(self, samples_path: str, pdf_dir: str, max_pages: Optional[int] = None, render_dpi: int = 72):
        with open(samples_path) as f:
            self.samples = json.load(f)
        self.pdf_dir = pdf_dir
        self.max_pages = max_pages
        self.render_dpi = render_dpi
        self._doc_cache: Dict[str, Any] = {}

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> RawDocument:
        from rag_docvqa_tpu_torch.data.pdf import load_pdf

        s = self.samples[idx]
        doc_id = s.get("doc_id", s.get("doc_name"))
        if doc_id not in self._doc_cache:
            self._doc_cache[doc_id] = load_pdf(
                os.path.join(self.pdf_dir, doc_id), render_images=False, dpi=self.render_dpi
            )
        words, boxes, _ = self._doc_cache[doc_id]
        if self.max_pages:
            words, boxes = words[: self.max_pages], boxes[: self.max_pages]
        answer = s.get("answer", "")
        fmt = s.get("answer_format", "Str")
        return RawDocument(
            question=s["question"],
            words=words,
            boxes=boxes,
            answers=[str(answer)],
            answer_page_idx=(s.get("evidence_pages") or [1])[0] - 1 if isinstance(s.get("evidence_pages"), list) else 0,
            question_id=idx,
            answer_type={"Int": "int", "Float": "float", "List": "list", "None": "not-answerable"}.get(fmt, "string"),
            extra={
                "answer_format": fmt,
                "evidence_pages": s.get("evidence_pages") or [],
                "evidence_sources": s.get("evidence_sources") or [],
                "doc_type": s.get("doc_type", "unknown"),
            },
        )


# --------------------------------------------------------------------------- #
# Noise-page injection (MP_DocVQA.py:225-904, DUDE.py:269-556)
# --------------------------------------------------------------------------- #
class NoisePagesWrapper(BaseDataset):
    """Injects `noise_pages` distractor pages per document.

    variant "v1": pool from held-out documents (MP_DocVQA.py:266-277);
    variant "v2": pool from other documents in-dataset (MP_DocVQA.py:680-712).
    `mix` shuffles noise pages into random positions and remaps
    answer_page_idx (mix_noise_pages, MP_DocVQA.py:451-512)."""

    def __init__(
        self,
        dataset: BaseDataset,
        noise_pages: int = 0,
        mix: bool = True,
        seed: int = 42,
        pool: Optional[List[Tuple[List[str], List[List[float]]]]] = None,
    ):
        self.dataset = dataset
        self.noise_pages = noise_pages
        self.mix = mix
        self.rng = random.Random(seed)
        self._pool = pool

    def _build_pool(self) -> List[Tuple[List[str], List[List[float]]]]:
        pool = []
        for d in self.dataset:
            for p in range(len(d.words)):
                pool.append((d.words[p], d.boxes[p]))
        return pool

    @property
    def pool(self):
        if self._pool is None:
            self._pool = self._build_pool()
        return self._pool

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> RawDocument:
        doc = self.dataset[idx]
        if self.noise_pages <= 0:
            return doc
        noise = self.rng.sample(self.pool, min(self.noise_pages, len(self.pool)))
        return inject_noise_pages(doc, noise, mix=self.mix, rng=self.rng)


def inject_noise_pages(
    doc: RawDocument,
    noise: List[Tuple[List[str], List[List[float]]]],
    mix: bool,
    rng: random.Random,
) -> RawDocument:
    n_orig = len(doc.words)
    words = list(doc.words) + [list(w) for w, _ in noise]
    boxes = list(doc.boxes) + [list(b) for _, b in noise]
    answer_page = doc.answer_page_idx
    if mix:
        positions = sorted(rng.choices(range(n_orig + 1), k=len(noise)))
        mixed_w: List[List[str]] = []
        mixed_b: List[List[List[float]]] = []
        new_answer = answer_page
        ni = 0
        for oi in range(n_orig + 1):
            while ni < len(positions) and positions[ni] == oi:
                mixed_w.append(words[n_orig + ni])
                mixed_b.append(boxes[n_orig + ni])
                ni += 1
            if oi < n_orig:
                if oi == answer_page:
                    new_answer = len(mixed_w)
                mixed_w.append(words[oi])
                mixed_b.append(boxes[oi])
        words, boxes, answer_page = mixed_w, mixed_b, new_answer
    return RawDocument(
        question=doc.question,
        words=words,
        boxes=boxes,
        answers=doc.answers,
        answer_page_idx=answer_page,
        question_id=doc.question_id,
        answer_type=doc.answer_type,
    )


def proportional_sampling_by_pages(
    records: Sequence[Any], target_size: int, page_count_fn, seed: int = 42
) -> List[Any]:
    """Page-count-proportional subsampling (MP_DocVQA.py:279-365): equal
    representation per page-count group, shortfall redistributed round-robin."""
    groups: Dict[int, List[Any]] = {}
    for r in records:
        groups.setdefault(page_count_fn(r), []).append(r)
    n_groups = len(groups)
    base, extra = divmod(target_size, n_groups)
    alloc: Dict[int, int] = {}
    shortfall = 0
    for i, (pages, items) in enumerate(sorted(groups.items())):
        want = base + (1 if i < extra else 0)
        alloc[pages] = min(want, len(items))
        shortfall += want - alloc[pages]
    if shortfall > 0:
        spare = [p for p in sorted(groups) if len(groups[p]) > alloc[p]]
        i = 0
        while shortfall > 0 and spare:
            p = spare[i % len(spare)]
            if len(groups[p]) > alloc[p]:
                alloc[p] += 1
                shortfall -= 1
                i += 1
            else:
                spare.remove(p)
    rng = random.Random(seed)
    out: List[Any] = []
    for pages, count in alloc.items():
        if count > 0:
            out.extend(rng.sample(groups[pages], count))
    return out


# --------------------------------------------------------------------------- #
# registry (reference build_dataset, build_utils.py:37-72)
# --------------------------------------------------------------------------- #
def build_dataset(config: Dict[str, Any], split: str) -> BaseDataset:
    if "dataset_name" not in config:
        raise SystemExit(
            "no dataset configured — pass a dataset config (-d configs/<name>.yml, "
            "e.g. -d configs/Synthetic.yml) or set dataset_name in the merged config"
        )
    name = config["dataset_name"]
    noise = name.endswith("-Noise")
    base_name = name[: -len("-Noise")] if noise else name
    pr = config.get("page_retrieval", "concat")

    if base_name == "MP-DocVQA":
        ds: BaseDataset = MPDocVQADataset(
            imdb_dir=config["imdb_dir"],
            images_dir=config.get("images_dir", ""),
            split=split,
            page_retrieval=pr,
            max_pages=config.get("max_pages", 1) or 1,
            size=config.get("size", 1.0),
            use_images=config.get("use_images", False),
            precomputed_layouts_path=config.get("precomputed_layouts_path")
            if config.get("use_precomputed_layouts")
            else None,
        )
    elif base_name == "SP-DocVQA":
        ds = SPDocVQADataset(
            imdb_dir=config["imdb_dir"],
            images_dir=config.get("images_dir", ""),
            split=split,
            use_images=config.get("use_images", False),
        )
    elif base_name == "Infographics":
        ds = InfographicsDataset(
            qas_path=config["qas_path"],
            ocr_dir=config["ocr_dir"],
            images_dir=config.get("images_dir", ""),
            use_images=config.get("use_images", False),
        )
    elif base_name == "DUDE":
        ds = DUDEDataset(config["dataset_dir"], split=split, page_retrieval=pr)
    elif base_name == "MMLongBenchDoc":
        ds = MMLongBenchDocDataset(
            samples_path=config["samples_path"],
            pdf_dir=config["pdf_dir"],
            max_pages=config.get("max_pages"),
        )
    else:
        raise ValueError(f"unknown dataset: {name}")

    if noise:
        ds = NoisePagesWrapper(
            ds,
            noise_pages=config.get("noise_pages", 0),
            mix=config.get("mix_noise_pages", True),
            seed=config.get("seed", 42),
        )
    return ds
