"""Declarative request router for the HOPAAS service.

Routes are registered as ``(method, path template, handler)`` triples with
typed path/query parameters and an optional request ``Schema`` — the
if-chain dispatch of the old ``HopaasServer.handle`` becomes data:

    Route("POST", "/api/v2/studies/{key}/trials:ask", handler,
          auth="bearer", request_schema=AskRequest)

Templates support ``{param}`` placeholders and Google-style custom verbs
(``resource:action``, including ``{uid}:tell`` — a placeholder with a
literal suffix).  Dispatch semantics:

  * unknown path                    -> 404 ``not_found``
  * known path, wrong method        -> 405 with an ``Allow`` header
  * auth failure (bearer or v1 path token) -> 401 ``unauthorized``
  * malformed JSON body             -> 400 ``invalid_json``
  * schema/query violations         -> 422 naming the offending field
  * handler ``ApiError``            -> its status + structured envelope
  * anything else                   -> 500 (a server never drops the socket)

All error payloads use the structured envelope (``errors.error_payload``).
The router is transport-independent: both the stdlib HTTP frontend and
``DirectTransport`` feed ``dispatch()``.
"""
from __future__ import annotations

import dataclasses
import re
import urllib.parse
from typing import Any, Callable

from .errors import ApiError, error_payload
from ..auth import AuthError, TokenManager, bearer_token

_SEGMENT_RE = re.compile(r"\{(\w+)\}(.*)")

# dispatch() result: (status, payload, response headers)
Response = tuple[int, dict[str, Any], dict[str, str]]


@dataclasses.dataclass(frozen=True)
class QueryParam:
    """A typed query-string parameter (``?limit=50&state=completed``)."""

    name: str
    kind: str = "str"                  # "str" | "int"
    default: Any = None
    choices: tuple | None = None
    min_value: int | None = None
    max_value: int | None = None
    doc: str = ""

    def parse(self, raw: dict[str, list[str]]) -> Any:
        if self.name not in raw:
            return self.default
        text = raw[self.name][-1]
        if self.kind == "int":
            try:
                value: Any = int(text)
            except ValueError:
                raise ApiError(422, "invalid_query",
                               f"query parameter {self.name!r} must be an "
                               f"integer, got {text!r}", field=self.name)
        else:
            value = text
        if self.choices is not None and value not in self.choices:
            raise ApiError(422, "invalid_query",
                           f"query parameter {self.name!r} must be one of "
                           f"{list(self.choices)}, got {value!r}",
                           field=self.name)
        if self.min_value is not None and isinstance(value, int) \
                and value < self.min_value:
            raise ApiError(422, "invalid_query",
                           f"query parameter {self.name!r} must be >= "
                           f"{self.min_value}", field=self.name)
        if self.max_value is not None and isinstance(value, int) \
                and value > self.max_value:
            raise ApiError(422, "invalid_query",
                           f"query parameter {self.name!r} must be <= "
                           f"{self.max_value}", field=self.name)
        return value


@dataclasses.dataclass
class Request:
    """Everything a handler sees — already authenticated and validated."""

    method: str
    path: str
    path_params: dict[str, str]
    query: dict[str, Any]
    headers: dict[str, str]
    body: dict[str, Any]
    identity: dict[str, Any] | None    # token payload (user, exp, jti)


class Route:
    """One (method, path template) -> handler binding."""

    def __init__(self, method: str, template: str,
                 handler: Callable[[Request], Any], *,
                 name: str = "", summary: str = "",
                 auth: str | None = "bearer",      # "bearer" | "path" | None
                 request_schema: type | None = None,
                 response_schema: type | None = None,
                 query_params: tuple[QueryParam, ...] = (),
                 tags: tuple[str, ...] = (),
                 ok_statuses: tuple[int, ...] = (200,)):
        assert auth in ("bearer", "path", None), auth
        self.method = method.upper()
        self.template = template
        self.handler = handler
        self.name = name or handler.__name__
        self.summary = summary
        self.auth = auth
        self.request_schema = request_schema
        self.response_schema = response_schema
        self.query_params = query_params
        self.tags = tags
        self.ok_statuses = ok_statuses
        self._segments: list[tuple[str | None, str]] = []
        for seg in (s for s in template.split("/") if s):
            m = _SEGMENT_RE.fullmatch(seg)
            if m:
                self._segments.append((m.group(1), m.group(2)))
            else:
                self._segments.append((None, seg))

    def path_param_names(self) -> list[str]:
        return [p for p, _ in self._segments if p is not None]

    def match(self, segments: list[str]) -> dict[str, str] | None:
        """Path params when ``segments`` matches this template, else None."""
        if len(segments) != len(self._segments):
            return None
        params: dict[str, str] = {}
        for actual, (param, literal) in zip(segments, self._segments):
            if param is None:
                if actual != literal:
                    return None
            elif literal:                  # "{uid}:tell" — literal suffix
                if not actual.endswith(literal) or len(actual) <= len(literal):
                    return None
                params[param] = actual[: -len(literal)]
            else:
                params[param] = actual
        return params


class Router:
    def __init__(self, tokens: TokenManager):
        self.tokens = tokens
        self.routes: list[Route] = []
        # hot-path index: only routes with the right segment count can
        # match, so dispatch scans a handful of candidates instead of
        # the whole route table
        self._by_length: dict[int, list[Route]] = {}

    def add(self, route: Route) -> Route:
        self.routes.append(route)
        self._by_length.setdefault(len(route._segments), []).append(route)
        return route

    # ------------------------------------------------------------------ #
    def dispatch(self, method: str, path: str,
                 body: Any = None, headers: dict[str, str] | None = None,
                 body_error: str | None = None) -> Response:
        clean_path, _, qs = (path or "").partition("?")
        segments = [s for s in clean_path.split("/") if s]
        matched: tuple[Route, dict[str, str]] | None = None
        allowed: set[str] = set()
        for route in self._by_length.get(len(segments), ()):
            params = route.match(segments)
            if params is None:
                continue
            allowed.add(route.method)
            if route.method == method.upper() and matched is None:
                matched = (route, params)
        if matched is None:
            if allowed:
                allow = ", ".join(sorted(allowed))
                return (405, error_payload(
                    "method_not_allowed",
                    f"{method.upper()} not allowed for {clean_path}; "
                    f"allowed: {allow}"), {"Allow": allow})
            return 404, error_payload("not_found",
                                      f"no route for {clean_path!r}"), {}
        route, path_params = matched
        if body_error is not None:
            return 400, error_payload("invalid_json", body_error), {}
        try:
            identity = self._authenticate(route, path_params, headers or {})
            query = {qp.name: qp.parse(urllib.parse.parse_qs(
                qs, keep_blank_values=True)) for qp in route.query_params}
            if route.request_schema is not None:
                body = route.request_schema.validate(body)
            elif body is not None and not isinstance(body, dict):
                raise ApiError(422, "invalid_body",
                               f"request body must be a JSON object, got "
                               f"{type(body).__name__}", field="$")
            req = Request(method=method.upper(), path=clean_path,
                          path_params=path_params, query=query,
                          headers=headers or {}, body=body or {},
                          identity=identity)
            return self._normalize(route.handler(req))
        except AuthError as e:
            return 401, error_payload("unauthorized", str(e)), {}
        except ApiError as e:
            return e.status, e.payload(), {}
        except Exception as e:   # a production server never drops the socket
            return 500, error_payload(
                "internal", f"{type(e).__name__}: {e}"), {}

    # ------------------------------------------------------------------ #
    def _authenticate(self, route: Route, path_params: dict[str, str],
                      headers: dict[str, str]) -> dict[str, Any] | None:
        if route.auth is None:
            return None
        if route.auth == "path":
            return self.tokens.verify(path_params.pop("token", ""))
        token = bearer_token(headers)
        if token is None:
            present = any(k.lower() == "authorization" for k in headers)
            raise AuthError(
                ("malformed" if present else "missing")
                + " Authorization header (expected 'Bearer <token>')")
        return self.tokens.verify(token)

    @staticmethod
    def _normalize(out: Any) -> Response:
        if isinstance(out, tuple):
            if len(out) == 3:
                return out
            status, payload = out
            return status, payload, {}
        return 200, out, {}
