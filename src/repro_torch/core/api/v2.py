"""The v2 resource-oriented surface.

Studies and trials are first-class resources with stable URLs; actions
on them use Google-style custom verbs (``:ask``, ``:tell``, ``:report``).
Auth is an ``Authorization: Bearer <token>`` header checked by the router
— tokens no longer ride in the URL path, so they stay out of access logs
and proxies.  Monitoring endpoints paginate with ``limit``/``cursor``
and answer from the storage's per-state indices (never a trial-list
scan).

    GET  /api/v2/version
    GET  /api/v2/health
    GET  /api/v2/openapi
    POST /api/v2/studies                        create-or-get (201 on create)
    GET  /api/v2/studies?limit&cursor
    GET  /api/v2/studies/{key}
    GET  /api/v2/studies/{key}/trials?state&limit&cursor
    POST /api/v2/studies/{key}/trials:ask
    POST /api/v2/studies/{key}/trials:ask_batch
    GET  /api/v2/trials/{uid}
    POST /api/v2/trials/{uid}:tell
    POST /api/v2/trials/{uid}:report
    POST /api/v2/trials:tell_batch
"""
from __future__ import annotations

from typing import Any

from . import schemas
from .router import QueryParam, Request, Route, Router

_PAGE = (
    QueryParam("limit", "int", default=100, min_value=1, max_value=500,
               doc="page size"),
    QueryParam("cursor", "int", default=None, min_value=0,
               doc="resume after this position (from next_cursor)"),
)
_STATE = QueryParam(
    "state", "str", default=None,
    choices=("running", "completed", "pruned", "failed"),
    doc="filter trials by state (served from the state-bucket index)")


def _worker_id(req: Request) -> str | None:
    return req.body.get("worker_id") or (req.identity or {}).get("user")


def register_v2(router: Router, server: Any) -> None:
    """Mount the v2 surface for ``server`` (a ``HopaasServer``)."""

    def version(req: Request):
        return server.op_version_v2()

    def openapi(req: Request):
        return server.openapi_document()

    def create_study(req: Request):
        created, resource = server.op_create_study(req.body)
        return (201 if created else 200), {"study": resource,
                                           "created": created}

    def list_studies(req: Request):
        studies, next_cursor = server.op_list_studies(
            cursor=req.query["cursor"], limit=req.query["limit"])
        return {"studies": studies, "next_cursor": next_cursor}

    def get_study(req: Request):
        return {"study": server.op_get_study(req.path_params["key"])}

    def list_trials(req: Request):
        trials, next_cursor = server.op_list_trials(
            req.path_params["key"], state=req.query["state"],
            cursor=req.query["cursor"], limit=req.query["limit"])
        return {"trials": trials, "next_cursor": next_cursor}

    def ask(req: Request):
        (trial,) = server.op_ask(req.path_params["key"], _worker_id(req), 1,
                                 parallelism=req.body.get("parallelism"))
        return trial

    def ask_batch(req: Request):
        trials = server.op_ask(req.path_params["key"], _worker_id(req),
                               req.body["n"],
                               parallelism=req.body.get("parallelism"))
        return {"trials": trials, "study_key": req.path_params["key"]}

    def get_trial(req: Request):
        return {"trial": server.op_get_trial(req.path_params["uid"])}

    def health(req: Request):
        return server.op_health()

    def tell(req: Request):
        return server.op_tell(req.path_params["uid"], req.body["value"],
                              req.body["state"],
                              req.body.get("idempotency_key"))

    def tell_batch(req: Request):
        return {"results": server.op_tell_batch(req.body["tells"])}

    def report(req: Request):
        return server.op_report(req.path_params["uid"], req.body["step"],
                                req.body["value"])

    v2 = ("v2",)
    for route in (
        Route("GET", "/api/v2/version", version, auth=None, tags=v2,
              summary="service version + storage/durability stats",
              response_schema=schemas.VersionResponse),
        Route("GET", "/api/v2/openapi", openapi, auth=None, tags=v2,
              summary="this document, generated from the route table"),
        Route("GET", "/api/v2/health", health, auth=None, tags=v2,
              summary="machine-readable readiness: role, lease epoch, "
                      "replication lag, WAL/fsync stats",
              response_schema=schemas.HealthResponse),
        Route("POST", "/api/v2/studies", create_study, tags=v2,
              summary="create a study (or return the existing one with "
                      "the same content key); 201 on creation",
              request_schema=schemas.StudySpec,
              response_schema=schemas.StudyEnvelope,
              ok_statuses=(200, 201)),
        Route("GET", "/api/v2/studies", list_studies, tags=v2,
              summary="paginated study list (monitoring)",
              query_params=_PAGE, response_schema=schemas.StudyPage),
        Route("GET", "/api/v2/studies/{key}", get_study, tags=v2,
              summary="one study resource",
              response_schema=schemas.StudyEnvelope),
        Route("GET", "/api/v2/studies/{key}/trials", list_trials, tags=v2,
              summary="paginated trial list; ?state= answers from the "
                      "per-state index, never a trial scan",
              query_params=(_STATE,) + _PAGE,
              response_schema=schemas.TrialPage),
        Route("POST", "/api/v2/studies/{key}/trials:ask", ask, tags=v2,
              summary="suggest one trial (idempotent per lease)",
              request_schema=schemas.AskRequest,
              response_schema=schemas.TrialResource),
        Route("POST", "/api/v2/studies/{key}/trials:ask_batch", ask_batch,
              tags=v2, summary="suggest k trials in one round trip",
              request_schema=schemas.AskBatchRequest,
              response_schema=schemas.AskBatchResponse),
        Route("GET", "/api/v2/trials/{uid}", get_trial, tags=v2,
              summary="one trial resource",
              response_schema=schemas.TrialEnvelope),
        Route("POST", "/api/v2/trials/{uid}:tell", tell, tags=v2,
              summary="finalize a trial (409 if already finalized)",
              request_schema=schemas.TellBody,
              response_schema=schemas.TellResponse),
        Route("POST", "/api/v2/trials/{uid}:report", report, tags=v2,
              summary="report an intermediate value; doubles as the lease "
                      "heartbeat and returns the pruning verdict",
              request_schema=schemas.ReportBody,
              response_schema=schemas.ReportResponse),
        Route("POST", "/api/v2/trials:tell_batch", tell_batch, tags=v2,
              summary="finalize k trials; per-item statuses, a straggler "
                      "conflict never fails the batch",
              request_schema=schemas.TellBatchRequest,
              response_schema=schemas.TellBatchResponse),
    ):
        router.add(route)
