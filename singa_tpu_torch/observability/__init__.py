"""Observability of the port: the metrics registry the serving engine
records into (counterpart of ``singa_tpu/observability``)."""

from . import metrics  # noqa: F401
