"""Evaluation metrics (``metrics``) and the program's spans, a memory report and a NaN guard (``observability``)."""
