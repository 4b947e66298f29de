"""HOPAAS wire layer: declarative router, typed schemas, versioned routes.

``build_router(server)`` assembles the full dispatch table — the v2
resource surface plus the v1 compat shim — for one ``HopaasServer``.
"""
from __future__ import annotations

from typing import Any

from .errors import ApiError, error_payload
from .openapi import build_openapi
from .router import QueryParam, Request, Response, Route, Router
from .schemas import Field, Schema
from .v1 import register_v1
from .v2 import register_v2


def build_router(server: Any) -> Router:
    router = Router(server.tokens)
    register_v2(router, server)
    register_v1(router, server)
    return router


__all__ = ["ApiError", "error_payload", "build_openapi", "build_router",
           "QueryParam", "Request", "Response", "Route", "Router",
           "Field", "Schema", "register_v1", "register_v2"]
