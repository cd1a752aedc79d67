"""Serving on the port's model substrate: prefill/decode steps (``step``)
and the fixed-slot batching engine (``engine``)."""
