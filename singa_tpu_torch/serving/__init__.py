"""Serving of the port (counterpart of ``singa_tpu/serving``): the request
queue, the KV caches (``kv_cache``), the continuous-batching
:class:`ServingEngine` of the Transformer LM and the stateless
:class:`BatchServingEngine`."""

from . import kv_cache  # noqa: F401
from .scheduler import (BlockPoolExhausted, EngineDraining,  # noqa: F401
                        HandoffRefused, PoolSaturated, QueueFull,
                        ReplicaCrashed, Request, RequestQueue, RequestShed,
                        RequestTimeout, ServeFuture, ServingError,
                        budget_remaining, deadline_in)
from .engine import (BatchServingEngine, ServingEngine,  # noqa: F401
                     build_engine)
