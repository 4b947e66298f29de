"""Python frontend for the HOPAAS service (the Zenodo ``hopaas_client`` role).

The client speaks the typed v2 surface: the token travels in an
``Authorization: Bearer`` header (never the URL path), studies are
first-class resources (``POST /api/v2/studies`` once, then
``…/trials:ask`` against the returned key), and failures carry the
structured error envelope — ``HopaasError`` exposes ``status``, ``code``
and the offending ``field``.

Idempotent calls retry transparently on connection resets, fabric 502s
(``bad_upstream``), 503s (overload, ``shard_migrating``) and retryable
error *codes* (``shard_failover`` while the fabric promotes a replica)
with exponential backoff + full jitter (``RetryPolicy``).  ``ask`` is
idempotent per lease (a duplicate suggestion is just another leased
trial the sweeper reclaims); ``tell``/``tell_batch`` attach a
client-generated idempotency key, constant across retries, so a resend
after a lost response makes the server replay the original result —
exactly-once, with no guessing about whether the first attempt landed.

    client = Client(transport, token)
    study = Study(name="opt", properties={"lr": space.loguniform(1e-5, 1e-1)},
                  direction="minimize", sampler={"name": "tpe"},
                  pruner={"name": "median"}, client=client)
    with study.trial() as trial:
        for step in range(epochs):
            loss = train_one_epoch(lr=trial.lr)
            if trial.should_prune(step, loss):
                break
        trial.loss = loss          # -> tell on context exit
"""
from __future__ import annotations

import contextlib
import dataclasses
import http.client
import random
import time
import urllib.parse
import uuid
from typing import Any, Iterator

from .. import spans
from .transport import Transport


class HopaasError(RuntimeError):
    """A failed service call, carrying the structured error envelope."""

    def __init__(self, message: str, *, status: int | None = None,
                 code: str | None = None, field: str | None = None,
                 payload: dict[str, Any] | None = None):
        super().__init__(message)
        self.status = status
        self.code = code
        self.field = field
        self.payload = payload or {}


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter for transient failures."""

    max_attempts: int = 3            # total tries, including the first
    base_delay: float = 0.05         # seconds; doubles per retry
    max_delay: float = 2.0
    # 503 = refused before processing (overload / shard_migrating);
    # 502 = the fabric router lost its worker mid-request (bad_upstream)
    retry_statuses: tuple[int, ...] = (502, 503)
    # error codes retried regardless of status: a fenced/deposed leader
    # answers 409 shard_failover while the fabric finishes promoting its
    # replica — the request is safe to replay against the new leader
    retry_codes: tuple[str, ...] = ("shard_failover",)

    def delay(self, attempt: int) -> float:
        """Backoff before retry #``attempt`` (1-based), with full jitter so
        a thundering herd of workers doesn't resynchronize."""
        cap = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        return cap * (0.5 + 0.5 * random.random())


# transport failures where the connection died underneath us — retryable
# for idempotent calls (the request may or may not have been processed)
_RETRYABLE_ERRORS = (ConnectionError, http.client.RemoteDisconnected,
                     http.client.BadStatusLine, http.client.CannotSendRequest)


# -- ergonomic space constructors (mirror hopaas_client.suggestions) -----
class suggestions:
    @staticmethod
    def uniform(low: float, high: float) -> dict:
        return {"type": "uniform", "low": low, "high": high}

    @staticmethod
    def loguniform(low: float, high: float) -> dict:
        return {"type": "loguniform", "low": low, "high": high}

    @staticmethod
    def int(low: int, high: int) -> dict:       # noqa: A003
        return {"type": "int", "low": low, "high": high}

    @staticmethod
    def logint(low: int, high: int) -> dict:
        return {"type": "logint", "low": low, "high": high}

    @staticmethod
    def categorical(choices: list) -> dict:
        return {"type": "categorical", "choices": choices}


class Client:
    def __init__(self, transport: Transport, token: str,
                 worker_id: str = "client",
                 retry: RetryPolicy | None = None):
        self.transport = transport
        self.token = token
        self.worker_id = worker_id
        self.retry = retry or RetryPolicy()

    # ------------------------------------------------------------------ #
    # request plumbing: header auth + retry with backoff
    # ------------------------------------------------------------------ #
    def _headers(self) -> dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"}

    def _request(self, method: str, path: str,
                 body: dict[str, Any] | None = None, *,
                 idempotent: bool = True, op: str = ""
                 ) -> tuple[int, dict[str, Any]]:
        """One logical call -> (status, payload), retrying idempotent
        requests on transport failures, retryable statuses (fabric 502
        ``bad_upstream`` / 503 overload) and retryable error codes
        (``shard_failover`` during a fabric promotion).  A resend is
        always safe: operations that mutate state carry idempotency
        keys, so the server replays rather than re-applies."""
        attempt = 0
        while True:
            try:
                status, payload = self.transport.request(
                    method, path, body, headers=self._headers())
            except _RETRYABLE_ERRORS as e:
                if not idempotent or attempt + 1 >= self.retry.max_attempts:
                    raise HopaasError(
                        f"{op or path} transport failure after "
                        f"{attempt + 1} attempts: {e!r}") from e
                attempt += 1
                time.sleep(self.retry.delay(attempt))
                continue
            code = ((payload.get("error") or {}).get("code")
                    if isinstance(payload, dict) else None)
            if ((status in self.retry.retry_statuses
                 or code in self.retry.retry_codes)
                    and idempotent
                    and attempt + 1 < self.retry.max_attempts):
                attempt += 1
                time.sleep(self.retry.delay(attempt))
                continue
            return status, payload

    @staticmethod
    def _raise_for(op: str, status: int, payload: dict[str, Any]) -> None:
        err = payload.get("error") or {}
        message = err.get("message") or payload.get("detail")
        raise HopaasError(f"{op} -> {status}: {message}", status=status,
                          code=err.get("code"), field=err.get("field"),
                          payload=payload)

    def _call(self, method: str, path: str,
              body: dict[str, Any] | None = None, *, op: str,
              ok: tuple[int, ...] = (200,), idempotent: bool = True
              ) -> dict[str, Any]:
        status, payload = self._request(method, path, body,
                                        idempotent=idempotent, op=op)
        if status not in ok:
            self._raise_for(op, status, payload)
        return payload

    @staticmethod
    def _qs(**params: Any) -> str:
        clean = {k: v for k, v in params.items() if v is not None}
        return f"?{urllib.parse.urlencode(clean)}" if clean else ""

    # ------------------------------------------------------------------ #
    # v2 surface
    # ------------------------------------------------------------------ #
    def version(self) -> str:
        return self._call("GET", "/api/v2/version", op="version")["version"]

    def ensure_study(self, spec: dict[str, Any]) -> tuple[str, bool]:
        """Create-or-get the study ``spec`` describes -> (key, created)."""
        payload = self._call("POST", "/api/v2/studies", spec,
                             op="create_study", ok=(200, 201))
        return payload["study"]["key"], payload["created"]

    def ask(self, study_key: str, worker_id: str | None = None,
            parallelism: int | None = None) -> dict[str, Any]:
        # parallelism = how many workers share this study; the server's
        # speculative precompute sizes its proposal buffer to cover one
        # wave of that many concurrent asks
        body: dict[str, Any] = {"worker_id": worker_id or self.worker_id}
        if parallelism is not None:
            body["parallelism"] = parallelism
        with spans.span("client.ask"):
            return self._call(
                "POST", f"/api/v2/studies/{study_key}/trials:ask",
                body, op="ask")

    def ask_batch(self, study_key: str, n: int,
                  worker_id: str | None = None,
                  parallelism: int | None = None) -> list[dict[str, Any]]:
        body: dict[str, Any] = {"n": n,
                                "worker_id": worker_id or self.worker_id}
        if parallelism is not None:
            body["parallelism"] = parallelism
        payload = self._call(
            "POST", f"/api/v2/studies/{study_key}/trials:ask_batch",
            body, op="ask_batch")
        return payload["trials"]

    def tell(self, trial_uid: str, value: Any = None,
             state: str = "completed") -> dict[str, Any]:
        # the key is constant across every retry of this logical tell:
        # a resend after a lost response (or a failover replay) makes
        # the server return the original result instead of a 409
        with spans.span("client.tell"):
            return self._call(
                "POST", f"/api/v2/trials/{trial_uid}:tell",
                {"value": value, "state": state,
                 "idempotency_key": uuid.uuid4().hex}, op="tell")

    def tell_batch(self, tells: list[dict[str, Any]]
                   ) -> list[dict[str, Any]]:
        items = [dict(t) for t in tells]
        for item in items:
            item.setdefault("idempotency_key", uuid.uuid4().hex)
        payload = self._call("POST", "/api/v2/trials:tell_batch",
                             {"tells": items}, op="tell_batch")
        return payload["results"]

    def report(self, trial_uid: str, step: int, value: float
               ) -> dict[str, Any]:
        return self._call("POST", f"/api/v2/trials/{trial_uid}:report",
                          {"step": step, "value": value}, op="report")

    def study(self, study_key: str) -> dict[str, Any]:
        return self._call("GET", f"/api/v2/studies/{study_key}",
                          op="study")["study"]

    def trial(self, trial_uid: str) -> dict[str, Any]:
        return self._call("GET", f"/api/v2/trials/{trial_uid}",
                          op="trial")["trial"]

    def trials_page(self, study_key: str, *, state: str | None = None,
                    limit: int = 100, cursor: int | None = None
                    ) -> dict[str, Any]:
        """One page: {"trials": [...], "next_cursor": int | None}."""
        qs = self._qs(state=state, limit=limit, cursor=cursor)
        return self._call("GET",
                          f"/api/v2/studies/{study_key}/trials{qs}",
                          op="trials")

    def iter_trials(self, study_key: str, *, state: str | None = None,
                    page_size: int = 200) -> Iterator[dict[str, Any]]:
        """All trials of a study, transparently paginating."""
        cursor: int | None = None
        while True:
            page = self.trials_page(study_key, state=state,
                                    limit=page_size, cursor=cursor)
            yield from page["trials"]
            cursor = page["next_cursor"]
            if cursor is None:
                return

    def studies(self) -> list[dict[str, Any]]:
        """All study resources (paginating under the hood)."""
        out: list[dict[str, Any]] = []
        cursor: int | None = None
        while True:
            qs = self._qs(limit=200, cursor=cursor)
            payload = self._call("GET", f"/api/v2/studies{qs}", op="studies")
            out.extend(payload["studies"])
            cursor = payload["next_cursor"]
            if cursor is None:
                return out

    def openapi(self) -> dict[str, Any]:
        return self._call("GET", "/api/v2/openapi", op="openapi")

    # ------------------------------------------------------------------ #
    # v1 compat helper (token in path) — kept for legacy callers/tests;
    # exercises the shim end to end
    # ------------------------------------------------------------------ #
    def _post(self, endpoint: str, body: dict[str, Any]) -> dict[str, Any]:
        status, payload = self._request(
            "POST", f"/api/{endpoint}/{self.token}", body,
            op=endpoint, idempotent=False)
        if status != 200:
            raise HopaasError(
                f"{endpoint} -> {status}: {payload.get('detail')}",
                status=status,
                code=(payload.get("error") or {}).get("code"),
                field=(payload.get("error") or {}).get("field"),
                payload=payload)
        return payload


class Trial:
    """A live trial.  Suggested hyperparameters are exposed as attributes
    (``trial.lr``) and via ``trial.params``."""

    def __init__(self, study: "Study", payload: dict[str, Any]):
        self._study = study
        # accepts both the v2 trial resource and the v1 ask payload
        self.uid: str = payload.get("uid") or payload["trial_uid"]
        self.id: int = payload["trial_id"]
        self.params: dict[str, Any] = (payload.get("params")
                                       if "params" in payload
                                       else payload["properties"])
        self.loss: float | None = None      # set by user code before exit
        self.pruned = False
        self.failed = False

    def __getattr__(self, name: str) -> Any:
        params = object.__getattribute__(self, "params")
        if name in params:
            return params[name]
        raise AttributeError(name)

    def should_prune(self, step: int, value: float) -> bool:
        payload = self._study._client.report(self.uid, step, value)
        if payload["should_prune"]:
            self.pruned = True
        return self.pruned


class Study:
    def __init__(self, name: str, properties: dict[str, Any],
                 direction: str = "minimize",
                 sampler: dict[str, Any] | None = None,
                 pruner: dict[str, Any] | None = None,
                 client: Client | None = None,
                 directions: list[str] | None = None):
        if client is None:
            raise ValueError("a Client is required")
        self.name = name
        self.properties = properties
        self.direction = direction
        self.directions = directions        # multi-objective when set
        self.sampler = sampler or {"name": "tpe"}
        self.pruner = pruner or {"name": "none"}
        self._client = client
        self.study_key: str | None = None

    def _spec_body(self) -> dict[str, Any]:
        body = {
            "name": self.name, "properties": self.properties,
            "direction": self.direction, "sampler": self.sampler,
            "pruner": self.pruner, "worker_id": self._client.worker_id,
        }
        if self.directions:
            body["directions"] = self.directions
        return body

    def _ensure_key(self) -> str:
        if self.study_key is None:
            self.study_key, _ = self._client.ensure_study(self._spec_body())
        return self.study_key

    def ask(self) -> Trial:
        return Trial(self, self._ask_payloads(1)[0])

    def ask_batch(self, n: int) -> list[Trial]:
        """Suggest ``n`` trials in one round trip; the server-side sampler
        sees the whole batch at once."""
        return [Trial(self, p) for p in self._ask_payloads(n)]

    def _ask_payloads(self, n: int) -> list[dict[str, Any]]:
        key = self._ensure_key()
        try:
            if n == 1:
                return [self._client.ask(key)]
            return self._client.ask_batch(key, n)
        except HopaasError as e:
            if e.code != "study_not_found":
                raise
            # the service restarted without its journal: re-create the
            # study (content-addressed, so the key is identical) and retry
            self.study_key = None
            key = self._ensure_key()
            if n == 1:
                return [self._client.ask(key)]
            return self._client.ask_batch(key, n)

    def tell_batch(self, results: list[tuple]) -> list[dict[str, Any]]:
        """Finalize many trials in one round trip.

        ``results`` holds ``(trial, value)`` or ``(trial, value, state)``
        tuples.  Returns per-trial outcomes; an already-finalized trial
        (straggler conflict, item status 409) never fails the batch.
        """
        tells = []
        for item in results:
            trial, value = item[0], item[1]
            state = item[2] if len(item) > 2 else None
            if state is None:
                state = ("pruned" if trial.pruned else
                         "failed" if trial.failed else "completed")
            tells.append({"trial_uid": trial.uid,
                          "value": trial.loss if value is None else value,
                          "state": state})
        return self._client.tell_batch(tells)

    def tell(self, trial: Trial, value: float | None = None,
             state: str | None = None) -> None:
        if state is None:
            state = ("pruned" if trial.pruned else
                     "failed" if trial.failed else "completed")
        self._client.tell(trial.uid,
                          value=trial.loss if value is None else value,
                          state=state)

    @contextlib.contextmanager
    def trial(self) -> Iterator[Trial]:
        t = self.ask()
        try:
            yield t
        except Exception:
            t.failed = True
            self.tell(t, state="failed")
            raise
        else:
            self.tell(t)
