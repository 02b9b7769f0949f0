"""Exceptions the port's serving engine and server raise.

The port's own copy of the classes in skypilot_tpu/infer/failures.py
that this slice uses.  The transient/fatal classifier and the restart
budget come with the supervised decode loop in a later slice; until
then any decode-step failure takes the replica down.
"""
from __future__ import annotations


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it produced a result."""


class RequestAbortedError(RuntimeError):
    """One request was dropped while the engine itself kept serving.
    ``__cause__`` carries the trigger."""


def wrap_abort(request_id: int, cause: BaseException) -> RequestAbortedError:
    err = RequestAbortedError(f'request {request_id} aborted: {cause!r}')
    err.__cause__ = cause
    return err
