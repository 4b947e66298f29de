"""Typed request/response schemas for the HOPAAS wire protocol.

Every request body is validated at the boundary by a ``Schema``: a named
set of ``Field`` specs (JSON kind, required/default, choices, bounds).
Validation failures raise ``ApiError(422, ...)`` naming the offending
field — malformed input never reaches a handler and never surfaces as a
500.  The same field specs drive the generated OpenAPI document
(``api.openapi``), so the docs cannot drift from the enforcement.

Schemas are intentionally *lenient about unknown keys* (ignored, for
forward compatibility) and *strict about known ones* (a wrong JSON type
is a 422, not a best-effort coercion).
"""
from __future__ import annotations

import copy
import math
from typing import Any

from .errors import ApiError
from ..pruners import known_pruners
from ..samplers import known_samplers

_MISSING = object()

# JSON-kind -> (python check, OpenAPI schema)
_KINDS = {
    "str": "string",
    "int": "integer",
    "number": "number",
    "bool": "boolean",
    "dict": "object",
    "list": "array",
    "any": None,
    "number_or_list": None,
}


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _require_finite(v: Any, field: str) -> None:
    """Reject NaN/±inf objective values at the boundary: bare ``NaN`` /
    ``Infinity`` literals are not valid strict JSON (the WAL refuses to
    serialize them) and NaN silently corrupts incumbent comparisons."""
    if _is_number(v) and not math.isfinite(v):
        raise ApiError(422, "invalid_value",
                       f"field {field!r} must be finite, got {v!r}",
                       field=field)


def _require_finite_tree(obj: Any, field: str) -> None:
    """Recursively reject non-finite numbers anywhere in a spec subtree —
    stdlib ``json.loads`` accepts bare ``NaN`` on the wire, but the WAL's
    strict serializer (rightly) refuses to write it back out."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _require_finite_tree(v, f"{field}.{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _require_finite_tree(v, f"{field}[{i}]")
    else:
        _require_finite(obj, field)


class Field:
    """One validated key of a JSON object body."""

    __slots__ = ("name", "kind", "required", "default", "nullable",
                 "choices", "min_value", "max_value", "item_kind", "doc")

    def __init__(self, name: str, kind: str, *, required: bool = False,
                 default: Any = None, nullable: bool = False,
                 choices: list | None = None, min_value: float | None = None,
                 max_value: float | None = None, item_kind: str | None = None,
                 doc: str = ""):
        assert kind in _KINDS, kind
        self.name, self.kind = name, kind
        self.required, self.default, self.nullable = required, default, nullable
        self.choices, self.min_value, self.max_value = choices, min_value, max_value
        self.item_kind, self.doc = item_kind, doc

    # -- validation -------------------------------------------------------
    def validate(self, body: dict[str, Any]) -> Any:
        if self.name not in body:
            if self.required:
                raise ApiError(422, "missing_field",
                               f"missing required field {self.name!r}",
                               field=self.name)
            # mutable defaults (sampler/pruner specs) must not be shared
            return copy.deepcopy(self.default)
        v = body[self.name]
        if v is None:
            if self.nullable or (not self.required and self.default is None):
                return None
            self._fail(v)
        self._check_kind(v, self.kind, self.name)
        if self.kind == "list" and self.item_kind is not None:
            for i, item in enumerate(v):
                self._check_kind(item, self.item_kind, f"{self.name}[{i}]")
                if self.choices is not None and item not in self.choices:
                    raise ApiError(
                        422, "invalid_value",
                        f"field {self.name!r}[{i}] must be one of "
                        f"{self.choices}, got {item!r}",
                        field=f"{self.name}[{i}]")
        elif self.choices is not None and v not in self.choices:
            raise ApiError(422, "invalid_value",
                           f"field {self.name!r} must be one of "
                           f"{self.choices}, got {v!r}", field=self.name)
        if self.min_value is not None and _is_number(v) and v < self.min_value:
            raise ApiError(422, "invalid_value",
                           f"field {self.name!r} must be >= {self.min_value}, "
                           f"got {v!r}", field=self.name)
        if self.max_value is not None and _is_number(v) and v > self.max_value:
            raise ApiError(422, "invalid_value",
                           f"field {self.name!r} must be <= {self.max_value}, "
                           f"got {v!r}", field=self.name)
        return v

    def _check_kind(self, v: Any, kind: str, label: str) -> None:
        ok = {
            "str": lambda: isinstance(v, str),
            "int": lambda: isinstance(v, int) and not isinstance(v, bool),
            "number": lambda: _is_number(v),
            "bool": lambda: isinstance(v, bool),
            "dict": lambda: isinstance(v, dict),
            "list": lambda: isinstance(v, list),
            "any": lambda: True,
            "number_or_list": lambda: _is_number(v) or (
                isinstance(v, list) and all(_is_number(x) for x in v)),
        }[kind]()
        if not ok:
            self._fail(v, label)

    def _fail(self, v: Any, label: str | None = None) -> None:
        label = label or self.name
        raise ApiError(422, "invalid_type",
                       f"field {label!r} must be {self.kind}, "
                       f"got {type(v).__name__}", field=label)

    # -- OpenAPI ----------------------------------------------------------
    def json_schema(self) -> dict[str, Any]:
        if self.kind == "number_or_list":
            out: dict[str, Any] = {"oneOf": [
                {"type": "number"},
                {"type": "array", "items": {"type": "number"}}]}
        elif self.kind == "any":
            out = {}
        else:
            out = {"type": _KINDS[self.kind]}
            if self.kind == "list" and self.item_kind in _KINDS \
                    and _KINDS[self.item_kind]:
                out["items"] = {"type": _KINDS[self.item_kind]}
        if self.choices is not None:
            out["enum"] = list(self.choices)
        if self.nullable:
            out["nullable"] = True
        if self.default is not None:
            out["default"] = self.default
        if self.doc:
            out["description"] = self.doc
        return out


class Schema:
    """A validated JSON-object body: ``validate`` returns the cleaned dict
    (defaults filled, unknown keys dropped) or raises ``ApiError(422)``."""

    NAME = "Schema"
    FIELDS: tuple[Field, ...] = ()

    @classmethod
    def validate(cls, body: Any) -> dict[str, Any]:
        if body is None:
            body = {}
        if not isinstance(body, dict):
            raise ApiError(422, "invalid_body",
                           f"request body must be a JSON object, got "
                           f"{type(body).__name__}", field="$")
        out = {f.name: f.validate(body) for f in cls.FIELDS}
        cls.post_validate(out)
        return out

    @classmethod
    def post_validate(cls, out: dict[str, Any]) -> None:
        """Cross-field checks; override in subclasses."""

    @classmethod
    def json_schema(cls) -> dict[str, Any]:
        required = [f.name for f in cls.FIELDS if f.required]
        schema: dict[str, Any] = {
            "type": "object",
            "properties": {f.name: f.json_schema() for f in cls.FIELDS},
        }
        if required:
            schema["required"] = required
        return schema


_DIRECTIONS = ["minimize", "maximize"]
_TELL_STATES = ["completed", "pruned", "failed"]


def _check_registry_name(spec: dict[str, Any], field: str, default: str,
                         known: list[str], code: str) -> None:
    name = spec.get("name", default)
    if not isinstance(name, str) or name not in known:
        raise ApiError(422, code,
                       f"unknown {field} {name!r}; known: {known}",
                       field=f"{field}.name")


class StudySpec(Schema):
    """Everything that unambiguously defines a study (paper sec. 2)."""

    NAME = "StudySpec"
    FIELDS = (
        Field("name", "str", default="unnamed", doc="study display name"),
        Field("properties", "dict", default={},
              doc="hyperparameter name -> space spec (or constant)"),
        Field("direction", "str", default="minimize", choices=_DIRECTIONS),
        Field("sampler", "dict", default={"name": "tpe"},
              doc="sampler spec, e.g. {'name': 'tpe'}"),
        Field("pruner", "dict", default={"name": "none"},
              doc="pruner spec, e.g. {'name': 'median'}"),
        Field("directions", "list", nullable=True, item_kind="str",
              choices=_DIRECTIONS,
              doc="per-objective directions (multi-objective studies)"),
        Field("worker_id", "str", nullable=True,
              doc="identity of the asking worker (defaults to the token user)"),
    )

    @classmethod
    def post_validate(cls, out: dict[str, Any]) -> None:
        _check_registry_name(out["sampler"], "sampler", "tpe",
                             known_samplers(), "unknown_sampler")
        _check_registry_name(out["pruner"], "pruner", "none",
                             known_pruners(), "unknown_pruner")
        for key in ("properties", "sampler", "pruner"):
            _require_finite_tree(out[key], key)


class AskRequest(Schema):
    """Body of ``POST /api/v2/studies/{key}/trials:ask``."""

    NAME = "AskRequest"
    FIELDS = (
        Field("worker_id", "str", nullable=True),
        Field("parallelism", "int", nullable=True, min_value=1,
              max_value=4096,
              doc="worker-fleet size hint: the speculative precompute "
                  "sizes its proposal buffer to cover one wave of this "
                  "many concurrent asks (ignored when speculation is "
                  "disabled)"),
    )


class AskBatchRequest(Schema):
    """Body of ``POST /api/v2/studies/{key}/trials:ask_batch``."""

    NAME = "AskBatchRequest"
    FIELDS = (
        Field("n", "int", default=1, min_value=1, max_value=4096,
              doc="number of trials to suggest in one round trip"),
        Field("worker_id", "str", nullable=True),
        Field("parallelism", "int", nullable=True, min_value=1,
              max_value=4096,
              doc="worker-fleet size hint: the speculative precompute "
                  "sizes its proposal buffer to cover one wave of this "
                  "many concurrent asks (ignored when speculation is "
                  "disabled)"),
    )


class TellBody(Schema):
    """Body of ``POST /api/v2/trials/{uid}:tell`` (uid in the path)."""

    NAME = "TellBody"
    FIELDS = (
        Field("value", "number_or_list", nullable=True,
              doc="final objective value (list = one per objective)"),
        Field("state", "str", default="completed", choices=_TELL_STATES),
        Field("idempotency_key", "str", nullable=True,
              doc="client-generated key, constant across retries of the "
                  "same logical tell; the server replays the original "
                  "result instead of double-applying (exactly-once)"),
    )

    @classmethod
    def post_validate(cls, out: dict[str, Any]) -> None:
        value = out.get("value")
        if isinstance(value, list):
            if not value:
                raise ApiError(422, "invalid_value",
                               "field 'value' must not be an empty list",
                               field="value")
            for i, item in enumerate(value):
                _require_finite(item, f"value[{i}]")
        else:
            _require_finite(value, "value")


class ReportBody(Schema):
    """Body of ``POST /api/v2/trials/{uid}:report`` — an intermediate
    value report doubling as the lease heartbeat (v1 ``should_prune``)."""

    NAME = "ReportBody"
    FIELDS = (
        Field("step", "int", default=0, min_value=0),
        Field("value", "number", default=0.0),
    )

    @classmethod
    def post_validate(cls, out: dict[str, Any]) -> None:
        _require_finite(out.get("value"), "value")


class TellItem(TellBody):
    """One element of a batched tell (uid carried inline)."""

    NAME = "TellItem"
    FIELDS = (Field("trial_uid", "str", required=True),) + TellBody.FIELDS


class TellBatchRequest(Schema):
    """Body of ``POST /api/v2/trials:tell_batch`` (and v1 tell_batch)."""

    NAME = "TellBatchRequest"
    FIELDS = (
        Field("tells", "list", required=True, item_kind="dict"),
    )

    @classmethod
    def post_validate(cls, out: dict[str, Any]) -> None:
        cleaned = []
        for i, item in enumerate(out["tells"]):
            try:
                cleaned.append(TellItem.validate(item))
            except ApiError as e:
                raise ApiError(e.status, e.code, f"tells[{i}]: {e.message}",
                               field=f"tells[{i}].{e.field or '$'}")
        out["tells"] = cleaned


# -- v1 request bodies (token in path, spec inline) -----------------------
class V1AskRequest(StudySpec):
    NAME = "V1AskRequest"


class V1AskBatchRequest(StudySpec):
    NAME = "V1AskBatchRequest"
    FIELDS = StudySpec.FIELDS + (
        Field("n", "int", default=1, min_value=1, max_value=4096),
    )


class V1TellRequest(TellItem):
    NAME = "V1TellRequest"


class V1ReportRequest(ReportBody):
    """v1 ``should_prune`` body — inherits the finite-value check."""
    NAME = "V1ReportRequest"
    FIELDS = (Field("trial_uid", "str", required=True),) + ReportBody.FIELDS


# -- response shapes (documentation only; emitted, never parsed) ----------
class TrialResource(Schema):
    NAME = "TrialResource"
    FIELDS = (
        Field("uid", "str", required=True),
        Field("trial_id", "int", required=True),
        Field("study_key", "str", required=True),
        Field("params", "dict", required=True),
        Field("state", "str", required=True,
              choices=["running", "completed", "pruned", "failed"]),
        Field("value", "number", nullable=True),
        Field("values", "list", nullable=True, item_kind="number"),
        Field("worker_id", "str", nullable=True),
        Field("retries", "int"),
        Field("last_step", "int"),
        Field("created_at", "number"),
        Field("finished_at", "number", nullable=True),
    )


class StudyResource(Schema):
    NAME = "StudyResource"
    FIELDS = (
        Field("key", "str", required=True),
        Field("name", "str", required=True),
        Field("n_trials", "int", required=True),
        Field("n_completed", "int", required=True),
        Field("n_pruned", "int", required=True),
        Field("n_failed", "int", required=True),
        Field("best_value", "number", nullable=True),
        Field("best_params", "dict", nullable=True),
        Field("n_running", "int"),
        Field("direction", "str", choices=_DIRECTIONS),
        Field("directions", "list", nullable=True, item_kind="str"),
        Field("sampler", "str"),
        Field("pruner", "str"),
        Field("data_version", "int",
              doc="storage shard mutation counter — equal versions mean "
                  "nothing changed; replayed identically across recovery"),
        Field("pareto_front", "list", nullable=True, item_kind="dict",
              doc="multi-objective studies only"),
    )


class StudyEnvelope(Schema):
    NAME = "StudyEnvelope"
    FIELDS = (
        Field("study", "dict", required=True, doc="a StudyResource"),
        Field("created", "bool"),
    )


class TrialEnvelope(Schema):
    NAME = "TrialEnvelope"
    FIELDS = (Field("trial", "dict", required=True, doc="a TrialResource"),)


class TrialPage(Schema):
    NAME = "TrialPage"
    FIELDS = (
        Field("trials", "list", required=True, item_kind="dict"),
        Field("next_cursor", "int", nullable=True,
              doc="pass as ?cursor= to fetch the next page; null = done"),
    )


class StudyPage(Schema):
    NAME = "StudyPage"
    FIELDS = (
        Field("studies", "list", required=True, item_kind="dict"),
        Field("next_cursor", "int", nullable=True),
    )


class AskBatchResponse(Schema):
    NAME = "AskBatchResponse"
    FIELDS = (
        Field("trials", "list", required=True, item_kind="dict"),
        Field("study_key", "str", required=True),
    )


class TellResponse(Schema):
    NAME = "TellResponse"
    FIELDS = (
        Field("uid", "str", required=True),
        Field("state", "str", required=True),
    )


class TellBatchResponse(Schema):
    NAME = "TellBatchResponse"
    FIELDS = (
        Field("results", "list", required=True, item_kind="dict",
              doc="per-item {status, uid, state|error}; one bad item never "
                  "fails the batch"),
    )


class ReportResponse(Schema):
    NAME = "ReportResponse"
    FIELDS = (
        Field("uid", "str", required=True),
        Field("should_prune", "bool", required=True),
        Field("note", "str", nullable=True,
              doc="set when the verdict comes from a revoked lease"),
    )


class VersionResponse(Schema):
    NAME = "VersionResponse"
    FIELDS = (
        Field("version", "str", required=True),
        Field("storage", "dict", nullable=True,
              doc="storage backend + durability stats (v2 only): backend, "
                  "fsync mode, snapshot/segment layout, WAL counters, "
                  "last recovery summary"),
    )


class HealthResponse(Schema):
    NAME = "HealthResponse"
    FIELDS = (
        Field("status", "str", required=True,
              choices=["ok", "follower", "fenced"],
              doc="ok = accepting writes; follower/fenced = redirect "
                  "(the fabric routes around non-leaders automatically)"),
        Field("version", "str", required=True),
        Field("worker", "str", required=True),
        Field("role", "str", required=True, choices=["leader", "follower"]),
        Field("epoch", "int", required=True,
              doc="leadership lease epoch (0 = never replicated)"),
        Field("replication", "dict", nullable=True,
              doc="mode, stream position, per-follower lag in "
                  "records/bytes (leaders) or sync status (followers)"),
        Field("storage", "dict", nullable=True,
              doc="WAL/fsync stats subset (backend, fsync mode, wal "
                  "records/bytes, fsyncs, group commits)"),
        Field("speculation", "dict", nullable=True,
              doc="speculative ask pipeline counters: queue hit/stale/"
                  "miss, published buffers, pending-trial count, "
                  "precompute rounds/errors"),
        Field("workers", "list", nullable=True, item_kind="dict",
              doc="fabric router only: per-worker health"),
    )


class ErrorEnvelope(Schema):
    NAME = "ErrorEnvelope"
    FIELDS = (
        Field("error", "dict", required=True,
              doc="{code, message, field?} — stable machine-readable shape"),
        Field("detail", "str", doc="mirror of error.message (v1 consumers)"),
    )
