"""In-memory static file server multiplexed on the websocket port.

Equivalent of the reference's ``HttpServer`` (reference:
streaming_decoder/http_server.py:19-83): preloads every file under the
doc root and serves it on plain-HTTP requests hitting the ws port.

Copied from asr_streaming_tpu/server/http_static.py.
"""

from __future__ import annotations

import mimetypes
import os
from typing import Dict, Optional, Tuple


class StaticFiles:
    def __init__(self, doc_root: Optional[str] = None):
        self.files: Dict[str, Tuple[bytes, str]] = {}
        if doc_root and os.path.isdir(doc_root):
            for root, _dirs, names in os.walk(doc_root):
                for name in names:
                    full = os.path.join(root, name)
                    rel = "/" + os.path.relpath(full, doc_root).replace(
                        os.sep, "/")
                    mime = mimetypes.guess_type(full)[0] or \
                        "application/octet-stream"
                    with open(full, "rb") as f:
                        self.files[rel] = (f.read(), mime)

    def lookup(self, path: str) -> Tuple[bool, bytes, str]:
        if path == "/":
            path = "/index.html"
        if path in self.files:
            body, mime = self.files[path]
            return True, body, mime
        return False, b"404 Not Found", "text/plain"
