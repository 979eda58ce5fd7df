"""--show_fingerprint provenance hash (flowdenoising.py:425-431): SHA-256 of
a source file streamed in 512-byte chunks."""

from __future__ import annotations

import hashlib


def file_fingerprint(path: str) -> str:
    h = hashlib.new("sha256")
    with open(path, "rb") as f:
        while chunk := f.read(512):
            h.update(chunk)
    return h.hexdigest()
