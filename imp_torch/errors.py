"""Errors shared by the port's layers."""

from __future__ import annotations


def deferred(what: str, item: int) -> NotImplementedError:
    """The error of an option the port does not have yet, naming its
    ROADMAP.md item."""
    return NotImplementedError(f"{what}: not ported yet, see ROADMAP.md §A item {item}")
