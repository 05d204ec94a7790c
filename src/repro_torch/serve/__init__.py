"""Serving: the batched decode engine (``serve.engine``)."""
