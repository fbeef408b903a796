"""Serving: the continuous-batching engine (``engine``), its micro-batcher
(``batcher``) and multi-process serving over a mesh (``multihost``); the
HTTP endpoint is ``scripts/serve_http.py``."""
