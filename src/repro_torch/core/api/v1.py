"""The v1 compat shim: the paper's RPC endpoints (Table 1) re-mounted as
thin adapters over the v2 core.

Paths, token-in-path auth, and success payloads are byte-compatible with
the pre-router service, so existing clients keep working unchanged:

    GET  /api/version
    POST /api/ask/{token}            body = study spec
    POST /api/ask_batch/{token}      body = study spec + n
    POST /api/tell/{token}           body = {trial_uid, value, state}
    POST /api/tell_batch/{token}     body = {tells: [...]}
    POST /api/should_prune/{token}   body = {trial_uid, step, value}
    GET  /api/studies/{token}

The only intentional behavior changes are fixes: a wrong method on a
known path is now 405 (with ``Allow``) instead of 404, and malformed
bodies are structured 400/422 errors instead of 500s.
"""
from __future__ import annotations

from typing import Any

from . import schemas
from .router import Request, Route, Router


def register_v1(router: Router, server: Any) -> None:
    """Mount the v1 shim for ``server`` (a ``HopaasServer``)."""

    def version(req: Request):
        return server.op_version()

    def ask(req: Request):
        return server._ask(req.body, req.identity or {})

    def ask_batch(req: Request):
        return server._ask_batch(req.body, req.identity or {})

    def tell(req: Request):
        return server._tell(req.body)

    def tell_batch(req: Request):
        return server._tell_batch(req.body)

    def should_prune(req: Request):
        return server._should_prune(req.body)

    def studies(req: Request):
        return server._studies()

    v1 = ("v1-compat",)
    for route in (
        Route("GET", "/api/version", version, auth=None, tags=v1,
              name="v1_version", summary="service version (v1)",
              response_schema=schemas.VersionResponse),
        Route("POST", "/api/ask/{token}", ask, auth="path", tags=v1,
              name="v1_ask", summary="suggest one trial (v1: study spec "
                                     "inline, token in path)",
              request_schema=schemas.V1AskRequest),
        Route("POST", "/api/ask_batch/{token}", ask_batch, auth="path",
              tags=v1, name="v1_ask_batch",
              summary="suggest k trials in one round trip (v1)",
              request_schema=schemas.V1AskBatchRequest),
        Route("POST", "/api/tell/{token}", tell, auth="path", tags=v1,
              name="v1_tell", summary="finalize a trial (v1)",
              request_schema=schemas.V1TellRequest),
        Route("POST", "/api/tell_batch/{token}", tell_batch, auth="path",
              tags=v1, name="v1_tell_batch",
              summary="finalize k trials (v1)",
              request_schema=schemas.TellBatchRequest),
        Route("POST", "/api/should_prune/{token}", should_prune, auth="path",
              tags=v1, name="v1_should_prune",
              summary="intermediate report + pruning verdict (v1)",
              request_schema=schemas.V1ReportRequest),
        Route("GET", "/api/studies/{token}", studies, auth="path", tags=v1,
              name="v1_studies", summary="study summaries (v1 monitoring)"),
    ):
        router.add(route)
