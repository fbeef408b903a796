"""Serving: the continuous-batching engine (``engine``) and its
micro-batcher (``batcher``); the HTTP endpoint is
``scripts/serve_http.py``."""
