"""PDF ingestion: character-level extraction -> words + normalized boxes.

The port's own copy of `rag_docvqa_tpu/data/pdf.py`: pdfminer's LTChar runs
are merged into words (split on spaces), a word's box is the union of its
characters' boxes normalized by the page box with a y-flip (PDF's origin is
bottom-left) and clipped to [0, 1]; page renders through pdf2image when asked
for. Both packages are imported at the call, and a missing one raises an
ImportError that names it (the JAX copy gives no renders, silently, whatever
failed).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def load_pdf(
    pdf_path: str,
    render_images: bool = True,
    dpi: int = 72,
) -> Tuple[List[List[str]], List[List[List[float]]], Optional[list]]:
    """Returns (words per page, normalized boxes per page, images or None)."""
    try:
        from pdfminer.converter import PDFPageAggregator
        from pdfminer.layout import LAParams, LTChar, LTTextBox
        from pdfminer.pdfinterp import PDFPageInterpreter, PDFResourceManager
        from pdfminer.pdfpage import PDFPage
    except ImportError as e:
        raise ImportError("reading a PDF's words and boxes needs pdfminer (the `pdfminer.six` package), which is "
                          "not installed") from e

    rsrcmgr = PDFResourceManager()
    device = PDFPageAggregator(rsrcmgr, laparams=LAParams())
    interpreter = PDFPageInterpreter(rsrcmgr, device)

    doc_words: List[List[str]] = []
    doc_boxes: List[List[List[float]]] = []
    with open(pdf_path, "rb") as fp:
        for page in PDFPage.get_pages(fp):
            interpreter.process_page(page)
            layout = device.get_result()
            page_words: List[str] = []
            page_boxes: List[List[float]] = []
            for text_object in layout:
                if not isinstance(text_object, LTTextBox):
                    continue
                for text_line in text_object:
                    word = ""
                    char_boxes: List[Tuple[float, float, float, float]] = []

                    def flush():
                        nonlocal word, char_boxes
                        if word:
                            cb = np.asarray(char_boxes)
                            page_words.append(word)
                            page_boxes.append(
                                [float(cb[:, 0].min()), float(cb[:, 1].min()), float(cb[:, 2].max()), float(cb[:, 3].max())]
                            )
                        word, char_boxes = "", []

                    for ch in text_line:
                        if isinstance(ch, LTChar) and ch.get_text() != " ":
                            word += ch.get_text()
                            char_boxes.append(ch.bbox)
                        else:
                            flush()
                    flush()
            # normalize + y-flip (process_pdf.py:47)
            w, h = layout.bbox[2], layout.bbox[3]
            page_boxes = [
                [b[0] / w, 1 - (b[3] / h), b[2] / w, 1 - (b[1] / h)] for b in page_boxes
            ]
            page_boxes = np.clip(np.asarray(page_boxes, np.float32).reshape(-1, 4), 0, 1).tolist()
            doc_words.append(page_words)
            doc_boxes.append(page_boxes)

    images = None
    if render_images:
        try:
            from pdf2image import convert_from_path
        except ImportError as e:
            raise ImportError("rendering a PDF's pages (render_images) needs the `pdf2image` package, which is not "
                              "installed") from e
        images = [np.asarray(im) for im in convert_from_path(pdf_path, dpi=dpi)]
    return doc_words, doc_boxes, images
