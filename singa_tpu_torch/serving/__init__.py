"""Serving of the port (counterpart of ``singa_tpu/serving``): the request
queue and the stateless :class:`BatchServingEngine`."""

from .scheduler import (EngineDraining, QueueFull, ReplicaCrashed,  # noqa: F401
                        Request, RequestQueue, RequestTimeout, ServeFuture,
                        ServingError)
from .engine import BatchServingEngine, build_engine  # noqa: F401
