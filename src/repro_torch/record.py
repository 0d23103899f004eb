"""The operands of the hand-written kernels' calls, for a recorder.

A kernel launched through ctypes reads and writes memory that PyTorch's
dispatcher never sees, and on the CPU the same wrapper runs plain PyTorch
ops that it does see.  So each wrapper reports, once a call, the tensors it
reads and writes to the recorder installed here
(:class:`.core.instrumentation.OperandAttributionSource` installs one
while it records a phase), and the ops it runs inside the call are not
recorded: the card and the CPU charge a call the same traffic.  With no
recorder installed a wrapper pays one global lookup.
"""

from __future__ import annotations

import functools
from typing import Callable

#: the installed recorder (``kernel_call(operands, fn, args, kwargs)``), or
#: None
recorder = None


def kernel(operands: Callable) -> Callable:
    """Decorator of a kernel wrapper.  ``operands(*args, out=result,
    **kwargs)`` gives ``(reads, writes)``, two sequences of tensors (None
    entries skipped), for the installed recorder."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = recorder
            if rec is None:
                return fn(*args, **kwargs)
            return rec.kernel_call(operands, fn, args, kwargs)
        return call
    return wrap
