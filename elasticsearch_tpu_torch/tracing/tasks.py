"""Cooperative cancellation of a flow of work.

Port of the flag part of elasticsearch_tpu/tracing/tasks.py: a ``Task``
that can be cancelled, the context variable naming the task the current
flow runs under, and ``check_cancelled``, the checkpoint long loops call
between units of work (by-query between docs, ``search/byquery.py``). A
whole-segment device program is not interruptible; the checkpoint runs
between them. The task registry, its listing and the REST handlers come
with ROADMAP A10e.
"""
from __future__ import annotations

import contextvars
import threading
from typing import Optional

from elasticsearch_tpu_torch.utils.errors import TaskCancelledException


class Task:
    """A unit of work that can be cancelled (reference: Task.java /
    CancellableTask): ``cancel`` sets the flag, ``check_cancelled``
    raises once it is set."""

    def __init__(self, task_id: int = 0, node: str = "", action: str = ""):
        self.id = task_id
        self.node = node
        self.action = action
        self.cancel_reason: Optional[str] = None
        self._cancelled = threading.Event()

    @property
    def tagged_id(self) -> str:
        return f"{self.node}:{self.id}"

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self, reason: str = "by user request") -> None:
        if not self._cancelled.is_set():
            self.cancel_reason = reason
            self._cancelled.set()

    def check_cancelled(self) -> None:
        if self._cancelled.is_set():
            raise TaskCancelledException(
                f"task [{self.tagged_id}] ({self.action}) was cancelled "
                f"[{self.cancel_reason or 'by user request'}]")


# the task the current flow of execution runs under; checkpoints read it
# without a handle passed through every call
_CURRENT_TASK: contextvars.ContextVar[Optional[Task]] = \
    contextvars.ContextVar("estpu-torch-current-task", default=None)


def current_task() -> Optional[Task]:
    return _CURRENT_TASK.get()


def set_current(task: Optional[Task]):
    """Make ``task`` the current task of this flow; returns the token
    ``reset_current`` takes."""
    return _CURRENT_TASK.set(task)


def reset_current(token) -> None:
    _CURRENT_TASK.reset(token)


def check_cancelled() -> None:
    """The cooperative checkpoint: nothing when the flow runs under no
    task; TaskCancelledException when its task was cancelled."""
    task = _CURRENT_TASK.get()
    if task is not None:
        task.check_cancelled()
