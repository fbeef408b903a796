"""Serving: the continuous-batching engine (``engine``), its micro-batcher
(``native/batcher.py``, C++; ``batcher`` is its pure-Python twin) and multi-process serving over a mesh (``multihost``); the
HTTP endpoint is ``scripts/serve_http.py``."""
