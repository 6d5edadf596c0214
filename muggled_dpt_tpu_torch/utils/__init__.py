"""Evaluation metrics (``metrics``) and tracing, memory and step-time helpers (``observability``)."""
