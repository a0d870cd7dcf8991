"""Tensors that the port builds once and keeps between calls.

Filter spectra, banks and tap tables are cached per shape, dtype and
device.  A cache hands every later call the same tensor, so that tensor must
be a normal one: built while ``torch.inference_mode()`` is on, it would be an
inference tensor, and a later call that records autograd could not save it
for backward.  Every cache of the port builds its tensors through
:func:`kept`, which turns inference mode off for the build, whatever the
caller's mode.
"""

from __future__ import annotations

import functools

import torch


def kept(build):
    """Decorate a function that builds the tensors of a cache (below a
    ``functools.lru_cache``, or called on a hand-kept cache's miss): it runs
    with inference mode off, so what it returns is a normal tensor."""

    @functools.wraps(build)
    def run(*args, **kwargs):
        with torch.inference_mode(False):
            return build(*args, **kwargs)

    return run
