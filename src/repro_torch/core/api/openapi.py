"""OpenAPI 3 document generated from the registered routes + schemas.

The document is *derived*, never hand-written: every ``Route`` on the
router contributes one operation, with parameters taken from its path
template and typed query params, and request/response bodies taken from
its ``Schema`` classes.  The route-consistency test asserts the
bijection (every registered route appears in the document and vice
versa), so the spec cannot drift from the dispatch table.
"""
from __future__ import annotations

from typing import Any

from .errors import ApiError  # noqa: F401  (documented error source)
from .router import Route, Router
from .schemas import ErrorEnvelope, Schema


def _ref(schema: type[Schema]) -> dict[str, Any]:
    return {"$ref": f"#/components/schemas/{schema.NAME}"}


def _operation(route: Route) -> dict[str, Any]:
    op: dict[str, Any] = {
        "operationId": route.name,
        "summary": route.summary or route.name,
    }
    if route.tags:
        op["tags"] = list(route.tags)
    params: list[dict[str, Any]] = []
    for name in route.path_param_names():
        desc = ("API token (v1 path-carried auth)" if name == "token"
                else "")
        params.append({"name": name, "in": "path", "required": True,
                       "schema": {"type": "string"},
                       **({"description": desc} if desc else {})})
    for qp in route.query_params:
        schema: dict[str, Any] = {
            "type": "integer" if qp.kind == "int" else "string"}
        if qp.choices is not None:
            schema["enum"] = list(qp.choices)
        if qp.default is not None:
            schema["default"] = qp.default
        if qp.min_value is not None:
            schema["minimum"] = qp.min_value
        if qp.max_value is not None:
            schema["maximum"] = qp.max_value
        params.append({"name": qp.name, "in": "query", "required": False,
                       "schema": schema,
                       **({"description": qp.doc} if qp.doc else {})})
    if params:
        op["parameters"] = params
    if route.request_schema is not None:
        op["requestBody"] = {
            "required": True,
            "content": {"application/json": {
                "schema": _ref(route.request_schema)}},
        }
    responses: dict[str, Any] = {}
    for status in route.ok_statuses:
        ok: dict[str, Any] = {
            "description": "created" if status == 201 else "success"}
        if route.response_schema is not None:
            ok["content"] = {"application/json": {
                "schema": _ref(route.response_schema)}}
        responses[str(status)] = ok
    responses["4XX"] = {
        "description": "structured error envelope "
                       "{error: {code, message, field?}}",
        "content": {"application/json": {"schema": _ref(ErrorEnvelope)}},
    }
    op["responses"] = responses
    if route.auth == "bearer":
        op["security"] = [{"bearerAuth": []}]
    return op


def build_openapi(router: Router, version: str) -> dict[str, Any]:
    paths: dict[str, dict[str, Any]] = {}
    components: dict[str, Any] = {ErrorEnvelope.NAME:
                                  ErrorEnvelope.json_schema()}
    for route in router.routes:
        paths.setdefault(route.template, {})[route.method.lower()] = \
            _operation(route)
        for schema in (route.request_schema, route.response_schema):
            if schema is not None:
                components.setdefault(schema.NAME, schema.json_schema())
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "HOPAAS service API",
            "version": version,
            "description": "Hyperparameter optimization as a service: "
                           "resource-oriented v2 surface plus the v1 "
                           "compat shim (token-in-path RPC endpoints).",
        },
        "paths": paths,
        "components": {
            "schemas": components,
            "securitySchemes": {
                "bearerAuth": {"type": "http", "scheme": "bearer",
                               "description": "HMAC-signed HOPAAS token in "
                                              "the Authorization header"},
            },
        },
    }
