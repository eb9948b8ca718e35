"""Named log channels.

Counterpart of ``singa_tpu/channel.py``. A :class:`Channel` appends
metric and progress lines to a per-channel file (``<directory>/<name>``
by default) and/or stderr. Channels are process-wide singletons obtained
through :func:`get_channel`. The JAX module writes through the native
runtime when it is built and through Python otherwise; the port has the
Python sink only (the native bindings are ROADMAP.md slice E).

Both spellings of the API: ``init_channel``/``InitChannel``,
``set_channel_directory``/``SetChannelDirectory``,
``get_channel``/``GetChannel``; per channel ``enable_dest_stderr``,
``enable_dest_file``, ``set_dest_file_path`` and ``send``.
"""

from __future__ import annotations

import os
import sys
import threading

__all__ = ["Channel", "init_channel", "set_channel_directory",
           "get_channel", "InitChannel", "SetChannelDirectory",
           "GetChannel"]

_lock = threading.Lock()
_channels = {}
_directory = ""


class Channel:
    """One named output channel: the file destination on, stderr off, by
    default."""

    def __init__(self, name):
        self.name = name
        self._file = None
        self._to_stderr = False
        self._to_file = True
        self._open(os.path.join(_directory, name) if _directory else name)

    def enable_dest_stderr(self, enable=True):
        self._to_stderr = bool(enable)

    def enable_dest_file(self, enable=True):
        self._to_file = bool(enable)

    def set_dest_file_path(self, path):
        self._open(path)

    def _open(self, path):
        if self._file is not None:
            self._file.close()
        try:
            self._file = open(path, "a")
        except OSError:
            self._file = None

    def send(self, message):
        msg = str(message)
        if self._to_stderr:
            print(msg, file=sys.stderr)
        if self._to_file and self._file is not None:
            self._file.write(msg + "\n")
            self._file.flush()


def init_channel(argv=None):
    """Global channel-system init: nothing to set up."""
    return None


def set_channel_directory(path):
    """Directory of the default per-channel files; affects channels made
    after the call."""
    global _directory
    with _lock:
        _directory = str(path)


def get_channel(name):
    """Get or create the channel singleton ``name``."""
    with _lock:
        ch = _channels.get(name)
        if ch is None:
            ch = Channel(name)
            _channels[name] = ch
        return ch


InitChannel = init_channel
SetChannelDirectory = set_channel_directory
GetChannel = get_channel
