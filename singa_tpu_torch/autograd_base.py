"""Global autograd mode flags.

Counterpart of ``singa_tpu/autograd_base.py:29-49`` (the ``CTX`` training
flag and :func:`is_training`). The tape and ``Operator`` arrive with the
training slice of the port (ROADMAP, slice A); the serving path runs under
``torch.inference_mode()`` and records nothing.
"""

from __future__ import annotations


class _Context:
    def __init__(self):
        self.training = False


CTX = _Context()


def is_training() -> bool:
    return CTX.training
