"""Structured API errors.

Every client-visible failure is an ``ApiError`` carrying an HTTP status,
a stable machine-readable ``code``, a human message, and (for validation
failures) the offending ``field``.  The wire shape is the v2 envelope

    {"error": {"code": ..., "message": ..., "field": ...}, "detail": ...}

``detail`` mirrors ``error.message`` so pre-v2 consumers that only read
``payload["detail"]`` keep working through the compat shim.
"""
from __future__ import annotations

from typing import Any


def error_payload(code: str, message: str, field: str | None = None
                  ) -> dict[str, Any]:
    err: dict[str, Any] = {"code": code, "message": message}
    if field is not None:
        err["field"] = field
    return {"detail": message, "error": err}


class ApiError(Exception):
    """A client-visible request failure (4xx) — never a dropped socket."""

    def __init__(self, status: int, code: str, message: str,
                 *, field: str | None = None):
        super().__init__(message)
        self.status = int(status)
        self.code = code
        self.message = message
        self.field = field

    def payload(self) -> dict[str, Any]:
        return error_payload(self.code, self.message, self.field)
