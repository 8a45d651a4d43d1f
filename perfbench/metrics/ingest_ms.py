"""Milliseconds a batch in `DocVQAIngestor.ingest` on the prefetch thread,
over the ingests begun inside the window (the benchmark's delegating
wrapper's host clock)."""


def read(run):
    spans = run.ingest_spans
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
